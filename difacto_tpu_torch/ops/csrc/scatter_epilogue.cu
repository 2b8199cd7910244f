// Fused-row scatter with the FTRL/AdaGrad epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_scatter_epilogue` (difacto_tpu/ops/fused.py:337),
// the push of every training step, and `_pallas_scatter` (:300), the same
// kernel with its epilogue off. For each j < n_rows with
// 0 <= slots[j] < capacity it writes one fused table row in place:
//
//   epilogue on:  table[slots[j]] = row_epilogue(rows[j], gw[j], gV[j], vmask[j])
//   epilogue off: table[slots[j]] = rows[j]            (`_pallas_scatter`)
//
// and leaves every other table row untouched (the ascending OOB pad lanes
// of the slot vector are dropped). `row_epilogue` is
// difacto_tpu_torch/updaters/sgd_updater.py's, which mirrors the JAX
// package's bit for bit:
//
//   * the scalar section (the last 32 bytes of the row) is 8 raw 32-bit
//     words whatever the container: (w, z, sqrt_g, cnt, live, scale_V,
//     scale_Vg, spare). They are read and written as words, never as
//     container lanes, so a bf16 or int8 lane holding half of an f32 is
//     never converted as a value;
//   * FTRL on (w, z, sqrt_g), lazy-V activation on live, cnt carried,
//     spare written as 0.0;
//   * on rows with vmask > 0: AdaGrad on V/Vg (dequantized from int8 or
//     fp8 codes with the scales of words 5/6 first), then the halves are
//     written back in the container: fp32; bf16 by torch's own
//     round-to-nearest-even cast on the card; or requantized with fresh
//     per-row scales into words 5/6, int8 codes rounding half to even,
//     clamped to +-127 and 0 for NaN as torch's cast makes them, fp8 codes
//     by c10's fp8e4m3fn_from_fp32_value (NaN for values that round past
//     448 and for +-Inf, as the JAX reference's ml_dtypes cast does); the
//     requant amax propagates NaN as torch.amax does; the pad lanes [k:h]
//     and [h+k:2h] become zeros. Rows with vmask == 0 keep their
//     embedding lanes bit for bit; the gap lanes [2h:off] of the appended
//     layout are always carried.
//
// Rounding is exact and never contracted: every operation is an explicit
// round-to-nearest intrinsic (__fadd_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn)
// in the order of the JAX source, so `a*b + c` can never become an FMA,
// whatever the build flags; rintf is jnp.round (half to even).
//
// Bound: data movement. The function reads 4 bytes of slot per lane and,
// per in-bounds row, the row, its gw and vmask words and (where vmask > 0)
// its 4k bytes of gV, and writes the row once; ~30 flops per embedding
// column are far below the card's rate.
//
// Design, a persistent pipeline of row tiles:
//   * The rows are cut into tiles of R consecutive rows (R = 16, or 8 for
//     rows of more than 256 bytes, fewer only if the ring below would not
//     fit). A tile's rows, slots, gw, vmask and gV are each one contiguous
//     span.
//   * The grid is persistent: min(tiles, resident blocks), the resident
//     count from cudaOccupancyMaxActiveBlocksPerMultiprocessor for this
//     build's registers and the launch's shared memory. Block b walks the
//     tiles b, b + grid, ... through a ring of 3 shared-memory stages that
//     cp.async fills (16-byte copies for the rows, 4-byte ones for the
//     per-row arrays) two tiles ahead of the one it computes, so one
//     tile's epilogue and writes overlap the next tiles' loads. On the
//     H100 this timed faster on the training push than one tile per block
//     with no ring (PERF.md), which needs 61 registers to this build's 47.
//   * Every input of a tile is requested in one batch before any branch:
//     the slot decides only whether and where the row goes. A row in an
//     out-of-bounds lane is read and dropped: no epilogue, no write.
//   * Epilogue: one lane per row runs the FTRL scalars, once per row.
//     The AdaGrad columns run on groups of G lanes, G the power of two
//     >= k and at most 32 (a half-warp per row at k = 16, a warp looping
//     over the columns at k = 64), several rows at once, and only on the
//     rows that take them (vmask > 0, a ballot's bit mask), packed onto
//     the first groups; a shuffle max within the group gives the requant
//     amax. When one pass of the groups leaves the last warp free, the
//     FTRL lanes sit there and the two chains run side by side. FTRL and
//     AdaGrad touch disjoint words of the staged row, so no barrier sits
//     between them.
//   * Each in-bounds row leaves once, as 16-byte vectors from its stage to
//     its table slot. Epilogue off: the ring stages rows and slots only,
//     and the rows leave as they came.
// Slots are unique, so each table row has one writer and no atomics are
// needed. Offsets are 64-bit: a full-width table is 2^31 bytes. Nothing is
// allocated and nothing synchronises with the host; the launch goes on the
// caller's stream and the return value is a CUDA error code (0 when the
// launch was taken), which the wrapper (difacto_tpu_torch/ops/fused.py)
// raises on.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;      // a block
constexpr int kMaxTileRows = 16;
constexpr int kTileBytes = 4096;   // rows are halved to 8 above this
constexpr int kStages = 3;         // the ring
static_assert(kThreads % 32 == 0 && kMaxTileRows <= 32 && kStages >= 2,
              "a block of whole warps; a tile's rows fit one ballot");

// container of the fused row; int8 and fp8 codes share the int8 container
enum Container : int { kF32 = 0, kBF16 = 1, kInt8 = 2, kFP8 = 3 };

struct Hyper {
  float l1, l2, lr, lr_beta, V_l2, V_lr, V_lr_beta, V_threshold;
};

// One launch's geometry, from make_plan(): the tile, the byte offsets of
// the per-row arrays inside a ring stage, and the requant scratch.
struct Plan {
  int tile_rows;    // R
  int row_bytes, k, h, off, container, esize;
  int group_shift;  // log2 of G, the lanes per row in the AdaGrad columns
  int stage_bytes, slots_at, gw_at, vmask_at, gv_at, scratch_at;
  int smem;         // dynamic shared memory of the launch
};

// ---- asynchronous copies, global to shared (cp.async) ----
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- numerics ----
__device__ __forceinline__ float nan_max(float a, float b) {
  // jnp.max / torch.amax propagate NaN; fmaxf would drop it
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float bf16_to_f32(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

__device__ __forceinline__ uint16_t f32_to_bf16_rne(float f) {
  // torch's own cast on the card (c10::BFloat16 on sm_80 and later):
  // cvt.rn.bf16.f32, round to nearest even, NaN to the canonical 0x7FFF
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

__device__ __forceinline__ float fp8e4m3fn_to_f32(uint8_t b) {
  const uint32_t sign = static_cast<uint32_t>(b & 0x80u) << 24;
  const uint32_t exp = (b >> 3) & 0xFu, man = b & 0x7u;
  if (exp == 0xFu && man == 0x7u) return __uint_as_float(sign | 0x7FC00000u);
  if (exp == 0u) {  // subnormal: man * 2^-9, exact in f32
    return __uint_as_float(sign | __float_as_uint(static_cast<float>(man) *
                                                  0.001953125f));
  }
  return __uint_as_float(sign | ((exp + 120u) << 23) | (man << 20));
}

__device__ __forceinline__ uint8_t f32_to_fp8e4m3fn(float f) {
  // c10's fp8e4m3fn_from_fp32_value: round to nearest even; NaN (0x7F)
  // at and above 480, for values that round up to it, and for +-Inf and
  // NaN
  const uint32_t fp8_max = 1087u << 20;
  const uint32_t denorm_mask = 141u << 23;
  uint32_t f_bits = __float_as_uint(f);
  const uint32_t sign = f_bits & 0x80000000u;
  f_bits ^= sign;
  uint8_t result;
  if (f_bits >= fp8_max) {
    result = 0x7Fu;
  } else if (f_bits < (121u << 23)) {
    f_bits = __float_as_uint(
        __fadd_rn(__uint_as_float(f_bits), __uint_as_float(denorm_mask)));
    result = static_cast<uint8_t>(f_bits - denorm_mask);
  } else {
    const uint32_t mant_odd = (f_bits >> 20) & 1u;
    f_bits += (static_cast<uint32_t>(7 - 127) << 23) + 0x7FFFFu;
    f_bits += mant_odd;
    result = static_cast<uint8_t>(f_bits >> 20);
  }
  return result | static_cast<uint8_t>(sign >> 24);
}

__device__ __forceinline__ float load_lane(const uint8_t* row, int lane,
                                           int container, float scale) {
  switch (container) {
    case kF32:
      return reinterpret_cast<const float*>(row)[lane];
    case kBF16:
      return bf16_to_f32(reinterpret_cast<const uint16_t*>(row)[lane]);
    case kInt8:
      return __fmul_rn(
          static_cast<float>(reinterpret_cast<const int8_t*>(row)[lane]),
          scale);
    default:
      return __fmul_rn(fp8e4m3fn_to_f32(row[lane]), scale);
  }
}

__device__ __forceinline__ void store_lane(uint8_t* row, int lane,
                                           int container, float v) {
  if (container == kF32) {
    reinterpret_cast<float*>(row)[lane] = v;
  } else {
    reinterpret_cast<uint16_t*>(row)[lane] = f32_to_bf16_rne(v);
  }
}

__device__ __forceinline__ void zero_lane(uint8_t* row, int lane,
                                          int esize) {
  if (esize == 4) {
    reinterpret_cast<uint32_t*>(row)[lane] = 0u;
  } else if (esize == 2) {
    reinterpret_cast<uint16_t*>(row)[lane] = 0u;
  } else {
    row[lane] = 0u;
  }
}

__device__ __forceinline__ uint8_t quant_code(float x, float scale,
                                              int container) {
  const float y = __fdiv_rn(x, scale);
  if (container == kInt8) {
    // torch.clamp keeps NaN, and its cast to int8 makes it 0
    const float r = rintf(y);
    if (r != r) return 0u;
    return static_cast<uint8_t>(
        static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f)));
  }
  return f32_to_fp8e4m3fn(y);
}

__device__ __forceinline__ float group_nan_max(float v, int G) {
  // the G lanes of a group are consecutive and G-aligned, so xor offsets
  // below G stay inside it; every lane of the warp takes part
  for (int o = G >> 1; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ bool in_table(int32_t s, int64_t capacity) {
  return s >= 0 && static_cast<int64_t>(s) < capacity;
}

// ---- the tile pipeline ----
template <bool kEpilogue>
__device__ __forceinline__ void load_tile(
    uint8_t* st, const Plan& p, int64_t t0, int nr, const int32_t* slots,
    const uint8_t* rows, const float* gw, const float* gV,
    const float* vmask) {
  const int tid = threadIdx.x;
  const int nvec = p.row_bytes >> 4;
  const uint8_t* src = rows + t0 * p.row_bytes;
  for (int v = tid; v < nr * nvec; v += kThreads)
    cp_async16(st + 16 * v, src + 16 * static_cast<int64_t>(v));
  for (int r = tid; r < nr; r += kThreads) {
    cp_async4(st + p.slots_at + 4 * r, slots + t0 + r);
    if (kEpilogue) {
      cp_async4(st + p.gw_at + 4 * r, gw + t0 + r);
      cp_async4(st + p.vmask_at + 4 * r, vmask + t0 + r);
    }
  }
  if (kEpilogue) {
    const float* g = gV + t0 * p.k;
    for (int e = tid; e < nr * p.k; e += kThreads)
      cp_async4(st + p.gv_at + 4 * e, g + e);
  }
}

// The epilogue of one staged tile, in place in its stage.
__device__ __forceinline__ void epilogue_tile(uint8_t* st, const Plan& p,
                                              int nr, int64_t capacity,
                                              const Hyper& hp,
                                              float* scratch) {
  const int tid = threadIdx.x;
  const int32_t* slot = reinterpret_cast<const int32_t*>(st + p.slots_at);
  const float* gw = reinterpret_cast<const float*>(st + p.gw_at);
  const float* vmask = reinterpret_cast<const float*>(st + p.vmask_at);
  const float* gV = reinterpret_cast<const float*>(st + p.gv_at);
  const int scal_at = p.off * p.esize;

  // The rows that take AdaGrad (in bounds, vmask > 0) as a bit mask, one
  // ballot in every warp: AdaGrad runs on those rows only, packed onto the
  // first groups of lanes, so no group idles through a row without it.
  const bool takes = (tid & 31) < nr && in_table(slot[tid & 31], capacity) &&
                     vmask[tid & 31] > 0.0f;
  const uint32_t todo = __ballot_sync(0xffffffffu, takes);
  const int n_todo = __popc(todo);
  const int G = 1 << p.group_shift;
  const int lane = tid & (G - 1);
  const int group = tid >> p.group_shift;
  const int n_groups = kThreads >> p.group_shift;

  // FTRL of row fr, in the JAX source's operation order, on the last warp
  // when one pass of those groups leaves it free (the two chains then run
  // side by side), else on the first; its words (0-4 and 7) are written
  // back after the AdaGrad columns
  const int fr = (n_todo << p.group_shift) <= kThreads - 32
                     ? tid - (kThreads - 32)
                     : tid;
  const bool ftrl = fr >= 0 && fr < nr && in_table(slot[fr], capacity);
  float w_new = 0.0f, z_new = 0.0f, sg_new = 0.0f;
  bool live_new = false;
  if (ftrl) {
    const uint32_t* scal =
        reinterpret_cast<const uint32_t*>(st + fr * p.row_bytes + scal_at);
    const float w = __uint_as_float(scal[0]);
    const float z = __uint_as_float(scal[1]);
    const float sg = __uint_as_float(scal[2]);
    const float cnt = __uint_as_float(scal[3]);
    const bool live = __uint_as_float(scal[4]) > 0.0f;
    const float g = __fadd_rn(gw[fr], __fmul_rn(hp.l2, w));
    sg_new = __fsqrt_rn(__fadd_rn(__fmul_rn(sg, sg), __fmul_rn(g, g)));
    z_new = __fsub_rn(
        z, __fsub_rn(g, __fmul_rn(__fdiv_rn(__fsub_rn(sg_new, sg), hp.lr),
                                  w)));
    const float eta = __fdiv_rn(__fadd_rn(hp.lr_beta, sg_new), hp.lr);
    const float sgn = z_new > 0.0f ? 1.0f : (z_new < 0.0f ? -1.0f : z_new);
    w_new = fabsf(z_new) <= hp.l1
                ? 0.0f
                : __fdiv_rn(__fsub_rn(z_new, __fmul_rn(sgn, hp.l1)), eta);
    live_new = live || (w_new != 0.0f && cnt > hp.V_threshold);
  }

  // AdaGrad: G lanes per row, group g on the g-th row of the mask, then
  // the (g + n_groups)-th. A warp leaves the loop only when all its groups
  // are past the last row, and the loop over columns has the same trip
  // count in every lane, so the shuffles of the requant see the whole warp.
  const int k = p.k, h = p.h;
  const bool quant = p.container >= kInt8;
  const int warp_group0 = (tid >> 5) << (5 - p.group_shift);
  float* fscr = scratch + group * 2 * k;  // this group's V', Vg' (requant)
  for (int i0 = 0; i0 + warp_group0 < n_todo; i0 += n_groups) {
    const bool active = i0 + group < n_todo;
    int r = 0;
    if (active) {  // the (i0 + group)-th set bit of the mask
      uint32_t m = todo;
      for (int j = 0; j < i0 + group; ++j) m &= m - 1;
      r = __ffs(m) - 1;
    }
    uint8_t* row = st + r * p.row_bytes;
    uint32_t* rscal = reinterpret_cast<uint32_t*>(row + scal_at);
    float sV = 1.0f, sVg = 1.0f;
    if (active && quant) {
      sV = __uint_as_float(rscal[5]);
      sVg = __uint_as_float(rscal[6]);
    }
    float amax_V = 0.0f, amax_Vg = 0.0f;
    for (int c0 = 0; c0 < k; c0 += G) {
      const int c = c0 + lane;
      if (!active || c >= k) continue;
      const float V = load_lane(row, c, p.container, sV);
      const float Vg = load_lane(row, h + c, p.container, sVg);
      const float gv = __fadd_rn(gV[r * k + c], __fmul_rn(hp.V_l2, V));
      const float Vg_new =
          __fsqrt_rn(__fadd_rn(__fmul_rn(Vg, Vg), __fmul_rn(gv, gv)));
      const float V_new = __fsub_rn(
          V, __fmul_rn(__fdiv_rn(hp.V_lr, __fadd_rn(Vg_new, hp.V_lr_beta)),
                       gv));
      if (quant) {
        fscr[c] = V_new;
        fscr[k + c] = Vg_new;
        amax_V = nan_max(amax_V, fabsf(V_new));
        amax_Vg = nan_max(amax_Vg, fabsf(Vg_new));
      } else {
        store_lane(row, c, p.container, V_new);
        store_lane(row, h + c, p.container, Vg_new);
      }
    }
    if (active) {
      // pad lanes of both halves become zeros (fuse_vvg pads with zeros);
      // in the in-pad layout the Vg pad ends where the scalars begin
      const int vg_pad_end = min(2 * h, p.off);
      for (int c = k + lane; c < h; c += G) zero_lane(row, c, p.esize);
      for (int c = h + k + lane; c < vg_pad_end; c += G)
        zero_lane(row, c, p.esize);
    }
    if (quant) {
      amax_V = group_nan_max(amax_V, G);
      amax_Vg = group_nan_max(amax_Vg, G);
      if (active) {
        const float qmax = p.container == kInt8 ? 127.0f : 448.0f;
        const float scale_V = amax_V > 0.0f ? __fdiv_rn(amax_V, qmax) : 1.0f;
        const float scale_Vg =
            amax_Vg > 0.0f ? __fdiv_rn(amax_Vg, qmax) : 1.0f;
        for (int c = lane; c < k; c += G) {
          row[c] = quant_code(fscr[c], scale_V, p.container);
          row[h + c] = quant_code(fscr[k + c], scale_Vg, p.container);
        }
        // every lane of the group read the old scales before the shuffles
        if (lane == 0) {
          rscal[5] = __float_as_uint(scale_V);
          rscal[6] = __float_as_uint(scale_Vg);
        }
      }
    }
  }

  if (ftrl) {  // cnt (word 3) is carried as it is
    uint32_t* scal =
        reinterpret_cast<uint32_t*>(st + fr * p.row_bytes + scal_at);
    scal[0] = __float_as_uint(w_new);
    scal[1] = __float_as_uint(z_new);
    scal[2] = __float_as_uint(sg_new);
    scal[4] = __float_as_uint(live_new ? 1.0f : 0.0f);
    scal[7] = 0u;
  }
}

// Each in-bounds row of a staged tile to its table slot, 16 bytes a lane.
__device__ __forceinline__ void store_tile(const uint8_t* st, const Plan& p,
                                           int nr, int64_t capacity,
                                           uint8_t* table) {
  const int32_t* slot = reinterpret_cast<const int32_t*>(st + p.slots_at);
  const int nvec = p.row_bytes >> 4;
  for (int v = threadIdx.x; v < nr * nvec; v += kThreads) {
    const int r = v / nvec;
    const int32_t s = slot[r];
    if (!in_table(s, capacity)) continue;
    reinterpret_cast<uint4*>(table + static_cast<int64_t>(s) *
                                         p.row_bytes)[v - r * nvec] =
        reinterpret_cast<const uint4*>(st)[v];
  }
}

__device__ __forceinline__ int tile_len(int64_t R, int64_t n_rows,
                                        int64_t t0) {
  return static_cast<int>(n_rows - t0 < R ? n_rows - t0 : R);
}

template <bool kEpilogue>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(uint8_t* __restrict__ table,
               const int32_t* __restrict__ slots,
               const uint8_t* __restrict__ rows,
               const float* __restrict__ gw,
               const float* __restrict__ gV,
               const float* __restrict__ vmask, int64_t capacity,
               int64_t n_rows, Plan p, Hyper hp) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int64_t R = p.tile_rows;
  const int64_t n_tiles = (n_rows + R - 1) / R;
  const int64_t first = blockIdx.x, stride = gridDim.x;
  if (first >= n_tiles) return;
  const int64_t mine = (n_tiles - 1 - first) / stride + 1;  // tiles of b

  // the ring: tile i of this block lives in stage i % kStages, and its
  // loads are one cp.async group, committed kStages - 1 tiles ahead
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < mine) {
      const int64_t t0 = (first + i * stride) * R;
      load_tile<kEpilogue>(smem + i * p.stage_bytes, p, t0,
                           tile_len(R, n_rows, t0), slots,
                           rows, gw, gV, vmask);
    }
    cp_async_commit();
  }
  for (int64_t i = 0; i < mine; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile i landed
    __syncthreads();  // everyone's; and tile i - 1's stage is drained
    const int64_t ahead = i + kStages - 1;
    if (ahead < mine) {
      const int64_t t0 = (first + ahead * stride) * R;
      load_tile<kEpilogue>(smem + (ahead % kStages) * p.stage_bytes, p, t0,
                           tile_len(R, n_rows, t0), slots,
                           rows, gw, gV, vmask);
    }
    cp_async_commit();  // an empty group past the end keeps the count
    uint8_t* st = smem + (i % kStages) * p.stage_bytes;
    const int64_t t0 = (first + i * stride) * R;
    const int nr = tile_len(R, n_rows, t0);
    if (kEpilogue) {
      epilogue_tile(st, p, nr, capacity, hp,
                    reinterpret_cast<float*>(smem + p.scratch_at));
      __syncthreads();
    }
    store_tile(st, p, nr, capacity, table);
  }
}

// ---- the host side ----
int align16(int64_t x) { return static_cast<int>((x + 15) / 16 * 16); }

// The tile: 16 rows, or 8 when 16 would pass kTileBytes, halved further
// until the ring fits the block's shared memory; false when not even one
// row does.
bool make_plan(Plan* p, int64_t row_bytes, int64_t k, int64_t h, int64_t off,
               int64_t container, bool epilogue, int smem_limit) {
  p->row_bytes = static_cast<int>(row_bytes);
  p->k = static_cast<int>(k);
  p->h = static_cast<int>(h);
  p->off = static_cast<int>(off);
  p->container = static_cast<int>(container);
  p->esize = container == kF32 ? 4 : (container == kBF16 ? 2 : 1);
  p->group_shift = 0;
  while ((1 << p->group_shift) < k && p->group_shift < 5) ++p->group_shift;
  const bool quant = epilogue && container >= kInt8;
  const int64_t scratch =
      quant ? static_cast<int64_t>(kThreads >> p->group_shift) * 8 * k : 0;
  int64_t R0 = kMaxTileRows;
  while (R0 > 8 && R0 * row_bytes > kTileBytes) R0 /= 2;
  for (int64_t R = R0; R >= 1; R /= 2) {
    int64_t at = align16(R * row_bytes);
    p->slots_at = static_cast<int>(at);
    at += align16(4 * R);
    p->gw_at = p->vmask_at = p->gv_at = static_cast<int>(at);
    if (epilogue) {
      at += align16(4 * R);
      p->vmask_at = static_cast<int>(at);
      at += align16(4 * R);
      p->gv_at = static_cast<int>(at);
      at += align16(4 * R * k);
    }
    const int64_t smem = kStages * at + scratch;
    if (smem <= smem_limit) {
      p->tile_rows = static_cast<int>(R);
      p->stage_bytes = static_cast<int>(at);
      p->scratch_at = static_cast<int>(kStages * at);
      p->smem = static_cast<int>(smem);
      return true;
    }
  }
  return false;
}

const void* kernel_of(bool epilogue) {
  return epilogue ? reinterpret_cast<const void*>(&scatter_kernel<true>)
                  : reinterpret_cast<const void*>(&scatter_kernel<false>);
}

// The device's SM count and opt-in shared memory, and both kernels allowed
// that much dynamic shared memory; cached per host thread and device.
struct Device {
  int id = -1, sms = 0, smem_optin = 0;
};

cudaError_t current_device(Device* out) {
  thread_local Device cached;
  int id = 0;
  cudaError_t rc = cudaGetDevice(&id);
  if (rc != cudaSuccess) return rc;
  if (cached.id != id) {
    Device d;
    d.id = id;
    rc = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, id);
    if (rc == cudaSuccess)
      rc = cudaDeviceGetAttribute(&d.smem_optin,
                                  cudaDevAttrMaxSharedMemoryPerBlockOptin, id);
    for (int e = 0; e < 2 && rc == cudaSuccess; ++e)
      rc = cudaFuncSetAttribute(kernel_of(e == 1),
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                d.smem_optin);
    if (rc != cudaSuccess) return rc;
    cached = d;
  }
  *out = cached;
  return cudaSuccess;
}

// Resident blocks per SM of a kernel at this shared memory, cached per
// host thread, device and route.
cudaError_t blocks_per_sm(const Device& d, bool epilogue, int smem,
                          int* out) {
  struct Entry {
    int dev = -1, smem = -1, blocks = 0;
  };
  thread_local Entry cache[2];
  Entry& e = cache[epilogue ? 1 : 0];
  if (e.dev != d.id || e.smem != smem) {
    int blocks = 0;
    const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel_of(epilogue), kThreads, smem);
    if (rc != cudaSuccess) return rc;
    if (blocks < 1) return cudaErrorInvalidConfiguration;
    e.dev = d.id;
    e.smem = smem;
    e.blocks = blocks;
  }
  *out = e.blocks;
  return cudaSuccess;
}

}  // namespace

extern "C" int difacto_scatter_epilogue(
    void* table, const int32_t* slots, const void* rows, const float* gw,
    const float* gV, const float* vmask, int64_t capacity, int64_t n_rows,
    int64_t row_bytes, int64_t k, int64_t h, int64_t off, int64_t container,
    int64_t epilogue, const float* hyper, void* stream) {
  if (n_rows <= 0) return 0;
  const Hyper hp{hyper[0], hyper[1], hyper[2], hyper[3],
                 hyper[4], hyper[5], hyper[6], hyper[7]};
  Device d;
  cudaError_t rc = current_device(&d);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  Plan p;
  if (!make_plan(&p, row_bytes, k, h, off, container, epilogue != 0,
                 d.smem_optin))
    return static_cast<int>(cudaErrorInvalidValue);
  int per_sm = 0;
  rc = blocks_per_sm(d, epilogue != 0, p.smem, &per_sm);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  // the persistent grid: every tile's block resident at once, or as many
  // blocks as are resident
  const int64_t tiles = (n_rows + p.tile_rows - 1) / p.tile_rows;
  const int64_t resident = static_cast<int64_t>(per_sm) * d.sms;
  const unsigned int blocks =
      static_cast<unsigned int>(tiles < resident ? tiles : resident);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* t = static_cast<uint8_t*>(table);
  const uint8_t* r = static_cast<const uint8_t*>(rows);
  if (epilogue) {
    scatter_kernel<true><<<blocks, kThreads, p.smem, st>>>(
        t, slots, r, gw, gV, vmask, capacity, n_rows, p, hp);
  } else {
    scatter_kernel<false><<<blocks, kThreads, p.smem, st>>>(
        t, slots, r, gw, gV, vmask, capacity, n_rows, p, hp);
  }
  return static_cast<int>(cudaGetLastError());
}
