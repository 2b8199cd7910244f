// Fused-row gather for Hopper (sm_90a).
//
// Replaces the TPU kernel `_pallas_gather` (difacto_tpu/ops/fused.py:254),
// which pulls the batch's sorted-unique slot rows of the fused slot table
// with R-row tiles of scalar-prefetched async DMAs. It computes the same
// function, the `mode=fill` gather contract:
//
//   out[j] = table[slots[j]]   if 0 <= slots[j] < C
//   out[j] = 0                 otherwise (the ascending OOB pad lanes)
//
// over a [C, row_bytes] table. The kernel is byte-level: the row of every
// container the store uses (fp32, bf16, or the int8 container of int8/fp8
// slots) is Wx * itemsize bytes with Wx a multiple of 128 lanes, so one
// kernel moving 16-byte vectors serves all of them; the wrapper
// (difacto_tpu_torch/ops/fused.py) checks that row_bytes is a multiple
// of 16 and that both pointers are 16-byte aligned.
//
// Bound: pure data movement. It reads each in-bounds row once and writes
// every output row once, 2 * u_cap * row_bytes bytes through HBM at most
// (plus 4 * u_cap bytes of slots), against 3.35 TB/s on an H100 SXM. At
// criteo_hashed.conf's main path (u_cap 12,288, rows of 128 lanes) that
// is 3.7 us in fp32, 1.9 us in bf16 and 0.9 us in int8. The floor of a
// launch that moves 8 rows is about 1.3 us on the H100 (PERF.md), so the
// narrow containers are bound by latency more than by bytes; the written
// rows may stay in the 50 MB L2 past the kernel's end, so a time under
// the bytes bound is possible.
//
// Design (the first kernel gave each row one warp, eight rows a block, one
// load in flight per lane, and left 16 of 32 lanes idle on bf16 rows and
// 24 on int8 ones; its grid of u_cap / 8 blocks ran ~1.45 waves):
//   * Lanes by width. A row takes a group of g = min(32, row_bytes / 16)
//     lanes, one 16-byte vector each, so a warp moves 512 bytes a pass at
//     every width: one fp32 row, two bf16 rows or four int8 rows of the
//     main path. Rows of more than 512 bytes loop over 32-vector chunks;
//     a width that does not divide 32 leaves 32 mod g lanes idle.
//   * Rows in flight. A warp owns tiles of P * R consecutive rows (P =
//     32 / g rows a pass, R passes): it loads the tile's R slot words (one
//     coalesced load a pass, the group's lanes reading one word), then all
//     R row vectors, then the R stores, so a lane has R independent loads
//     in flight behind one slot round trip instead of a chain per row.
//   * Persistent grid. At most kBlocksPerSM (4) blocks of 8 warps share an
//     SM; R is the least of 1, 2 and 4 whose tiles those warps hold at
//     once (beyond 4 the warps stride over the tiles), and the grid is
//     min(tiles / 8, resident blocks), the resident count from
//     cudaOccupancyMaxActiveBlocksPerMultiprocessor. So no partial wave
//     is left, and at the main path every row is in flight in the one
//     wave: fp32 R = 4, bf16 R = 2, int8 R = 1, 384 blocks each. Fewer,
//     deeper warps timed faster there than a full SM of shallow ones.
// A bulk-copy variant (one thread issuing cp.async.bulk rows into a
// 3-stage shared-memory ring on mbarriers, one bulk store a tile) computed
// the same and timed slower on the H100 at every width (PERF.md), so it is
// not kept.
// Offsets are 64-bit: a full-width table is 2^31 bytes. Nothing is
// allocated here and nothing synchronises; the launch goes on the caller's
// stream and the return value is a CUDA error code (0 when the launch was
// taken), which the wrapper raises on.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// A warp's geometry at one row width: g lanes a row (one 16-byte vector
// each), per_pass = 32 / g rows a pass, and magic = ceil(2^16 / g), with
// which (lane * magic) >> 16 is lane / g for every lane < 32 and g <= 32,
// so the kernel divides by no run-time value.
struct Lanes {
  int vecs, g, per_pass, magic;
};

// One 16-byte vector of a table row, cached in L2 only (a row is read
// once). A coherent load and not the read-only path: ptxas may not move a
// store above it, so a tile's R loads stay ahead of all its stores (with
// __ldg it moved the first row's store up behind that row's load, a
// second latency round on the H100).
__device__ __forceinline__ uint4 load_vec(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.cg.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p)
               : "memory");
  return v;
}

template <int R>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const uint4* __restrict__ table,
                   const int32_t* __restrict__ slots,
                   uint4* __restrict__ out, int64_t capacity,
                   int64_t n_slots, Lanes w, int64_t tiles) {
  // the warp's first tile (the grid is at most the resident blocks, so
  // this fits an int), then its lane's place: both before the one exit
  const int first = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int q = (lane * w.magic) >> 16;   // this lane's row in the pass
  const int sub = lane - q * w.g;         // its vector in the row's chunk
  if (q >= w.per_pass || first >= tiles) return;  // 32 mod g idle lanes
  const int tile_rows = w.per_pass * R;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  int64_t t = first;
  do {
    const int64_t base = t * tile_rows + q;
    int64_t src[R];                       // the row's first vector, or -1
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int64_t j = base + i * w.per_pass;
      const int32_t s = j < n_slots ? __ldg(slots + j) : -1;
      src[i] = (s >= 0 && static_cast<int64_t>(s) < capacity)
                   ? static_cast<int64_t>(s) * w.vecs : -1;
    }
    for (int c = sub; c < w.vecs; c += w.g) {
      uint4 v[R];
#pragma unroll
      for (int i = 0; i < R; ++i)
        v[i] = src[i] >= 0 ? load_vec(table + src[i] + c)
                           : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int64_t j = base + i * w.per_pass;
        if (j < n_slots) out[j * w.vecs + c] = v[i];
      }
    }
    t += stride;
  } while (t < tiles);
}

using Kernel = void (*)(const uint4*, const int32_t*, uint4*, int64_t,
                        int64_t, Lanes, int64_t);

constexpr int kDepths = 3;                // R = 1, 2, 4
const Kernel kKernels[kDepths] = {&gather_rows_kernel<1>,
                                  &gather_rows_kernel<2>,
                                  &gather_rows_kernel<4>};

// At most this many blocks of a launch share an SM (of the 8 that fit):
// at the main path's sizes fewer, deeper warps timed faster than a full SM
// of shallow ones on the H100 (PERF.md).
constexpr int kBlocksPerSM = 4;

// Devices whose figures each host thread keeps (ids past it are refused).
constexpr int kMaxDevices = 64;

// Warps each kernel keeps on the card at once (its resident blocks per SM,
// from its registers, at most kBlocksPerSM, times the SMs), cached per
// host thread and device, so launches that alternate between the shards'
// cards never query again.
cudaError_t resident_warps(int64_t out[kDepths]) {
  struct Entry {
    bool known = false;
    int64_t warps[kDepths];
  };
  thread_local Entry cache[kMaxDevices];
  int id = 0;
  cudaError_t rc = cudaGetDevice(&id);
  if (rc != cudaSuccess) return rc;
  if (id < 0 || id >= kMaxDevices) return cudaErrorInvalidDevice;
  Entry& e = cache[id];
  if (!e.known) {
    int sms = 0;
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, id);
    for (int k = 0; k < kDepths && rc == cudaSuccess; ++k) {
      int blocks = 0;
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kKernels[k], kThreads, 0);
      if (rc == cudaSuccess && (blocks < 1 || sms < 1))
        rc = cudaErrorInvalidConfiguration;
      if (blocks > kBlocksPerSM) blocks = kBlocksPerSM;
      e.warps[k] = static_cast<int64_t>(blocks) * sms * kWarps;
    }
    if (rc != cudaSuccess) return rc;
    e.known = true;
  }
  for (int k = 0; k < kDepths; ++k) out[k] = e.warps[k];
  return cudaSuccess;
}

}  // namespace

// The warps that each of the kernels with R = 1, 2 and 4 keeps on the
// current device at once, the widths at which the launch deepens R and at
// which the warps start to loop (the tests' edge cases read them). Returns
// a CUDA error code.
extern "C" int difacto_gather_resident_warps(int64_t* out) {
  return static_cast<int>(resident_warps(out));
}

extern "C" int difacto_gather_rows(const void* table, const int32_t* slots,
                                   void* out, int64_t capacity,
                                   int64_t n_slots, int64_t row_bytes,
                                   void* stream) {
  const int64_t vecs = row_bytes / 16;
  if (n_slots <= 0 || vecs <= 0) return 0;
  if (vecs > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  Lanes w;
  w.vecs = static_cast<int>(vecs);
  w.g = w.vecs < 32 ? w.vecs : 32;
  w.per_pass = 32 / w.g;
  w.magic = (65536 + w.g - 1) / w.g;
  int64_t warps[kDepths];
  const cudaError_t rc = resident_warps(warps);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  // rows in flight per lane: the least R whose tiles its resident warps
  // hold at once, else the deepest and a loop
  int k = 0;
  int64_t tiles = 0;
  for (;; ++k) {
    const int64_t tile_rows = static_cast<int64_t>(w.per_pass) << k;
    tiles = (n_slots + tile_rows - 1) / tile_rows;
    if (tiles <= warps[k] || k == kDepths - 1) break;
  }
  const int64_t needed = (tiles + kWarps - 1) / kWarps;
  const int64_t resident = warps[k] / kWarps;
  const unsigned int blocks =
      static_cast<unsigned int>(needed < resident ? needed : resident);
  kKernels[k]<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(table), slots, static_cast<uint4*>(out),
      capacity, n_slots, w, tiles);
  return static_cast<int>(cudaGetLastError());
}
