// Chunked-run FM backward for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's `_fm_grad_panel_chunked`
// (difacto_tpu/losses/fm.py) is jnp, which XLA fuses on the TPU. On the
// card the same function in torch ops (difacto_tpu_torch/losses/fm.py,
// `_fm_grad_panel_chunked`, the plain version) made ~22 launches a step
// and wrote and read again [C, L, k+1] temporaries of every chunk's token
// rows, and its per-lane sum (`torch.segment_reduce`) walked each lane's
// chunks on one thread, however many. This kernel computes, for the
// batch's U slot lanes, with pad slots (row B) read as zeros, as the plain
// version reads them, and pad chunks (lane >= U) dropped:
//
//   gw[u]     = sum over lane u's tokens of x * p[row]
//   xxp[u]    = sum of p[row] * (x * x)          (gw itself on binary panels)
//   t1[u, :]  = sum of (p[row] * XV[row, :]) * x (x == 1 on binary panels)
//   gV[u, :]  = (t1[u, :] - xxp[u] * Vm[u, :]) * vm[u],  Vm = V * vm
//
// with each token's products in the plain version's order. Sums: a
// chunk's L tokens in slot order; a lane's chunks in chunk order, in
// groups of kS chunks counted from the lane's first chunk, each group
// summed in order and the group partials summed in order. The cut
// depends on chunk_lane alone and no atomics are used, so a batch gives
// the same bits on every run; a lane of at most kS chunks is summed in
// the plain version's chunk order. Every operation is an explicit
// round-to-nearest intrinsic, so no product is contracted into an FMA.
//
// Bound: bytes. The call reads chunk_idx, chunk_vals and chunk_lane once
// (~40 MB at the benchmark's batches of 65,536 Criteo rows), V and
// v_mask once, p and XV ([B, k], which stay in the 50 MB L2) once per
// token, and writes gw and gV once: 64 MB at V_dim 16 and 142 MB at
// V_dim 64 (chip_smoke.py phase 23), 19 us and 42 us at 3.35 TB/s. Each
// token's XV row is read again from the L2 (~0.19 GB and ~0.75 GB a call),
// and each slot costs the team a few dozen instructions, so the kernel
// runs at about a tenth of that bound (PERF.md).
//
// Design, three launches on the caller's stream:
//   1. lane_starts: starts[u] = the first chunk of lane >= u, for u <= U,
//      a binary search a lane over the ascending chunk_lane (the plain
//      version's searchsorted); a lane with no chunk gets the epilogue of
//      zero sums here.
//   2. group_sums: a team of T lanes (T the power of two >= k, from 4 to
//      32; lane i holds columns i, i + T, ... of a 64-column tile) takes
//      the groups that begin in one run of kS chunks, so every team has
//      at most 2 kS - 1 chunks of work, whatever the lane lengths: a
//      skewed lane (a field of 3 values, or lane 0 with every empty cell
//      of the panel, ~23k chunks) is cut into groups that teams sum side
//      by side. The team walks its chunks in one loop, a two-stage
//      pipeline in shared memory: while it sums chunk c, cp.async copies
//      chunk c + 1's token rows (XV by neighbouring lanes on neighbouring
//      columns, p one lane a slot, the values as 16-byte vectors) into
//      the other stage, chunk c + 2's slots load (four 16-byte loads) and
//      the L2 fetches chunk c + kAhead's. So every row of a chunk is in
//      flight at once, short lanes cost no round trip of their own, and
//      the compiler cannot serialise the gathers behind their uses. A
//      group that is its lane's only one writes the lane's gw and gV (its
//      V row and mask loaded a chunk ahead); any other group writes its
//      partial to scratch[leader chunk, :k+2], and the team records the
//      lane of more than kS chunks that begins in its run (one at most).
//   3. lane_totals: a block a span of kThreads runs takes the long lanes
//      recorded there (lane 0's ~730 partials among them), copies each
//      one's group partials to shared memory with every thread of the
//      block, and a thread a column adds them in order; then the lane's
//      gw and gV.
// The wrapper (difacto_tpu_torch/ops/fused.py, fm_chunk_grad_cuda)
// allocates the outputs, starts[U + 1], long_lane[ceil(C / kS)] and
// scratch[C, k + 2]; nothing is allocated here and nothing synchronises
// with the host. chunk_lane must ascend, as every single-card layout's
// does (ops/batch.py); it is not checked, which would sync the step. The
// return value is a CUDA error code (0 when every launch was taken),
// which the wrapper raises on.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kL = 16;          // token slots a chunk (ops/batch.CHUNK_L)
constexpr int kS = 32;          // chunks a group
constexpr int kThreads = 128;   // a block
constexpr int kTile = 64;       // columns a team holds (T <= 32, CPL <= 2)
constexpr int kAhead = 4;       // chunks between an L2 prefetch and its use
// lane_totals: a block's shared copy of group partials (40 KB), and the
// columns (k + 2 <= kThreads * kColsPerThread) a thread adds
constexpr int kTotalsFloats = 10240;
constexpr int kColsPerThread = 4;

struct Args {
  const float* p;         // [B]
  const float* xv;        // [B, k], rows ldx apart
  const int32_t* idx;     // [C, kL], pad slots B
  const int32_t* lane;    // [C] ascending, pad chunks >= U
  const float* vals;      // [C, kL] or null (binary panel)
  const void* V;          // [U, k] f32 or bf16, rows ldv apart
  const float* vmask;     // [U]
  int32_t* starts;        // [U + 1]
  int32_t* long_lane;     // [ceil(C / kS)]: the lane of more than kS
                          // chunks that begins in each run of kS chunks
  float* scratch;         // [C, k + 2]
  float* gw;              // [U]
  float* gV;              // [U, k]
  int64_t ldx, ldv, B, C, U;
  int k, v_bf16;
};

// A team of T lanes holds CPL columns a lane, W = T * CPL of a tile:
// lane i the columns col0 + i + j * T, j < CPL.
template <int T, int CPL>
struct Team {
  static constexpr int W = T * CPL;
  static constexpr int kPerBlock = kThreads / T;
  // floats of a stage of a team's shared memory (group_sums keeps two): a
  // chunk's gathered p[kL], x[kL] and XV[kL][W]
  static constexpr int kStage = 2 * kL + kL * W;
};

// Lane u's epilogue inputs over this team lane's columns: vm and V (as
// f32; a bf16 V widens exactly). Loaded ahead of the lane's sums.
template <int CPL>
struct LaneV {
  float v[CPL];
  float vm;
};

// V[u, c] as f32 (a bf16 V widens exactly).
__device__ __forceinline__ float v_at(const Args& a, int64_t u, int c) {
  const int64_t at = u * a.ldv + c;
  return a.v_bf16
      ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.V)[at])
      : __ldg(static_cast<const float*>(a.V) + at);
}

// A column's epilogue: gV = (t1 - xxp * Vm) * vm, with Vm = V * vm in
// V's dtype (bf16: torch's product rounded to bf16, exact before the
// rounding).
__device__ __forceinline__ float grad_v(const Args& a, float t1, float xxp,
                                        float v, float vm) {
  const float Vm = a.v_bf16
      ? __bfloat162float(__float2bfloat16_rn(
            __fmul_rn(v, __bfloat162float(__float2bfloat16_rn(vm)))))
      : __fmul_rn(v, vm);
  return __fmul_rn(__fsub_rn(t1, __fmul_rn(xxp, Vm)), vm);
}

template <int T, int CPL>
__device__ __forceinline__ void load_v(const Args& a, int64_t u, int col,
                                       LaneV<CPL>& lv) {
  lv.vm = __ldg(a.vmask + u);
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = col + j * T;
    lv.v[j] = v_at(a, u, c < a.k ? c : 0);
  }
}

// The epilogue of lane u over this team lane's columns, and gw.
template <int T, int CPL>
__device__ __forceinline__ void write_lane(const Args& a, int64_t u,
                                           int col, const float (&t1)[CPL],
                                           float gw, float xxp,
                                           const LaneV<CPL>& lv) {
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = col + j * T;
    if (c < a.k) a.gV[u * a.k + c] = grad_v(a, t1[j], xxp, lv.v[j], lv.vm);
  }
  if (col == 0) a.gw[u] = gw;
}

// starts[u] for u <= U; a lane with no chunk gets the epilogue of zero
// sums here (its V row read by this one thread).
__global__ void lane_starts(const Args a) {
  const int64_t u = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (u > a.U) return;
  int64_t lo = 0, hi = a.C;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a.lane[mid] < u)
      lo = mid + 1;
    else
      hi = mid;
  }
  a.starts[u] = static_cast<int32_t>(lo);
  if (u == a.U || (lo < a.C && a.lane[lo] == u)) return;
  const float vm = __ldg(a.vmask + u);
  for (int c = 0; c < a.k; ++c)
    a.gV[u * a.k + c] = grad_v(a, 0.f, 0.f, v_at(a, u, c), vm);
  a.gw[u] = 0.f;
}

// ---- asynchronous copies, global to shared (cp.async) ----
// 4 bytes, or 4 zeros where `bytes` is 0 (nothing is read then).
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          uint32_t bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
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

// The lanes of this thread's team, for __syncwarp.
template <int T>
__device__ __forceinline__ unsigned team_mask() {
  return T == 32 ? 0xffffffffu
                 : ((1u << T) - 1) << ((threadIdx.x & 31) & ~(T - 1));
}

__device__ __forceinline__ void load_idx(const Args& a, int64_t c,
                                         int4 (&ri)[kL / 4]) {
  const int4* ip = reinterpret_cast<const int4*>(a.idx + c * kL);
#pragma unroll
  for (int q = 0; q < kL / 4; ++q) ri[q] = __ldg(ip + q);
}

// Start the copies of chunk c's token rows into a stage (a shared
// address): every slot's XV columns (this lane's) and p (one lane a
// slot), and the chunk's values. A pad slot (row B) reads nothing and
// stages zeros, which add 0 as the plain version's zero row does.
template <int T, int CPL, bool kValued>
__device__ __forceinline__ void gather(const Args& a, int64_t c,
                                       const int4 (&ri)[kL / 4],
                                       uint32_t stage, int tl, int col) {
  constexpr int W = Team<T, CPL>::W;
  const int r[kL] = {ri[0].x, ri[0].y, ri[0].z, ri[0].w, ri[1].x, ri[1].y,
                     ri[1].z, ri[1].w, ri[2].x, ri[2].y, ri[2].z, ri[2].w,
                     ri[3].x, ri[3].y, ri[3].z, ri[3].w};
  const float* xv = a.xv + col;
#pragma unroll
  for (int t = 0; t < kL; ++t) {
    const bool real = r[t] < a.B;
    const float* src = xv + (real ? static_cast<int64_t>(r[t]) * a.ldx : 0);
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      if (col + j * T < a.k)
        cp_async4(stage + 4 * (2 * kL + t * W + tl + j * T), src + j * T,
                  real ? 4u : 0u);
  }
  // p: lane tl stages slots tl, tl + T, ... (its row read once more, from
  // the L1)
#pragma unroll
  for (int t0 = 0; t0 < kL; t0 += T) {
    if (t0 + tl < kL) {
      const int row = __ldg(a.idx + c * kL + t0 + tl);
      const bool real = row < a.B;
      cp_async4(stage + 4 * (t0 + tl), a.p + (real ? row : 0),
                real ? 4u : 0u);
    }
  }
  if (kValued)
    for (int q = tl; q < kL / 4; q += T)
      cp_async16(stage + 4 * (kL + 4 * q), a.vals + c * kL + 4 * q);
}

// A chunk's sums over its slots in slot order, from its stage, added to
// the group's (t1, gw, xxp).
template <int T, int CPL, bool kValued>
__device__ __forceinline__ void add_chunk(const float* stage, int tl,
                                          float (&t1)[CPL], float& gw,
                                          float& xxp) {
  constexpr int W = Team<T, CPL>::W;
  const float* vs = stage + 2 * kL + tl;
  float pc[CPL], pw = 0.f, px = 0.f;
#pragma unroll
  for (int j = 0; j < CPL; ++j) pc[j] = 0.f;
#pragma unroll
  for (int t = 0; t < kL; ++t) {
    const float pr = stage[t];
    if (kValued) {
      const float x = stage[kL + t];
      pw = __fadd_rn(pw, __fmul_rn(pr, x));
      px = __fadd_rn(px, __fmul_rn(pr, __fmul_rn(x, x)));
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        pc[j] = __fadd_rn(pc[j],
                          __fmul_rn(__fmul_rn(pr, vs[t * W + j * T]), x));
    } else {
      pw = __fadd_rn(pw, pr);
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        pc[j] = __fadd_rn(pc[j], __fmul_rn(pr, vs[t * W + j * T]));
    }
  }
#pragma unroll
  for (int j = 0; j < CPL; ++j) t1[j] = __fadd_rn(t1[j], pc[j]);
  gw = __fadd_rn(gw, pw);
  xxp = __fadd_rn(xxp, px);
}

// A team walks the groups that begin in its run [c0, c0 + kS) of chunks,
// chunk by chunk: while it sums chunk c from one stage, the copies of
// chunk c + 1's rows fill the other, the slots of chunk c + 2 load, and
// the L2 fetches chunk c + kAhead. A lane's first chunk starts a group,
// and so does every kS-th chunk after it. Returns the lane of more than
// kS chunks that begins in the run, or -1 (a run of kS chunks holds the
// start of one such lane at most).
template <int T, int CPL, bool kValued>
__device__ __forceinline__ int walk_groups(const Args& a, int64_t c0,
                                           float* stages, int tl, int col) {
  using G = Team<T, CPL>;
  const uint32_t stage0 =
      static_cast<uint32_t>(__cvta_generic_to_shared(stages));
  const int64_t c_end = c0 + kS < a.C ? c0 + kS : a.C;
  int64_t c = c0;
  int u = a.lane[c];
  if (u >= a.U) return -1;                    // the pad chunks trail
  int64_t s = a.starts[u];                    // lane u's first chunk
  const int64_t lead0 = s + (c - s) / kS * kS;
  if (lead0 < c) {
    // the group holding c0 begins before it: the team before sums it
    const int64_t e = a.starts[u + 1];
    c = lead0 + kS < e ? lead0 + kS : e;
    if (c >= c_end) return -1;
    if (c == e) {
      u = a.lane[c];
      if (u >= a.U) return -1;
      s = c;
    }
  }
  int long_lane = -1;
  int4 ri[kL / 4];
  load_idx(a, c, ri);
  gather<T, CPL, kValued>(a, c, ri, stage0, tl, col);
  cp_async_commit();
  if (c + 1 < a.C) load_idx(a, c + 1, ri);
  int next_lane = c + 1 < a.C ? a.lane[c + 1] : static_cast<int>(a.U);
  LaneV<CPL> lv, next_lv;
  load_v<T, CPL>(a, u, col, lv);
  int64_t lead = c;
  int buf = 0;
  float t1[CPL], gw = 0.f, xxp = 0.f;
#pragma unroll
  for (int j = 0; j < CPL; ++j) t1[j] = 0.f;
  for (;;) {
    // every lane is done with the stage chunk c + 1 is copied into
    __syncwarp(team_mask<T>());
    if (c + 1 < a.C)
      gather<T, CPL, kValued>(a, c + 1, ri,
                              stage0 + 4 * (buf ^ 1) * G::kStage, tl, col);
    cp_async_commit();
    if (c + 2 < a.C) load_idx(a, c + 2, ri);
    if (c + kAhead < a.C) {
      asm volatile("prefetch.global.L2 [%0];" ::"l"(a.idx + (c + kAhead) * kL));
      if (kValued)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(a.vals +
                                                        (c + kAhead) * kL));
    }
    const int after = c + 2 < a.C ? a.lane[c + 2] : static_cast<int>(a.U);
    const bool lane_ends = next_lane != u;
    if (lane_ends && next_lane < a.U)
      load_v<T, CPL>(a, next_lane, col, next_lv);
    cp_async_wait<1>();                       // chunk c's copies
    __syncwarp(team_mask<T>());
    add_chunk<T, CPL, kValued>(stages + buf * G::kStage, tl, t1, gw, xxp);
    if (lane_ends || (c + 1 - s) % kS == 0) {
      if (lead == s && lane_ends) {
        write_lane<T, CPL>(a, u, col, t1, gw, kValued ? xxp : gw, lv);
      } else {
        if (lead == s) long_lane = u;         // its first group
        float* row = a.scratch + lead * (a.k + 2);
#pragma unroll
        for (int j = 0; j < CPL; ++j)
          if (col + j * T < a.k) row[col + j * T] = t1[j];
        if (col == 0) {
          row[a.k] = gw;
          row[a.k + 1] = xxp;
        }
      }
      if (c + 1 >= c_end) break;              // the next team's group
      if (lane_ends) {
        u = next_lane;
        if (u >= a.U) break;
        s = c + 1;
        lv = next_lv;
      }
      lead = c + 1;
#pragma unroll
      for (int j = 0; j < CPL; ++j) t1[j] = 0.f;
      gw = 0.f;
      xxp = 0.f;
    }
    ++c;
    buf ^= 1;
    next_lane = after;
  }
  cp_async_wait<0>();                         // the copies of chunk c + 1
  return long_lane;
}

template <int T, int CPL, bool kValued>
__global__ void __launch_bounds__(kThreads) group_sums(const Args a) {
  using G = Team<T, CPL>;
  extern __shared__ float smem[];
  const int tl = threadIdx.x & (T - 1);
  const int64_t team =
      blockIdx.x * static_cast<int64_t>(G::kPerBlock) + threadIdx.x / T;
  if (team * kS >= a.C) return;
  const int col = blockIdx.y * kTile + tl;
  const int long_lane = walk_groups<T, CPL, kValued>(
      a, team * kS, smem + (threadIdx.x / T) * 2 * G::kStage, tl, col);
  if (col == 0) a.long_lane[team] = long_lane;
}

// A block a span of kThreads runs: the long lanes recorded in them, one
// after the other, each by the whole block. Its group partials are copied
// to shared memory, as many as fit at a time, and each column's thread
// adds them in order; then the lane's epilogue.
template <bool kValued>
__global__ void __launch_bounds__(kThreads) lane_totals(const Args a) {
  __shared__ float rows[kTotalsFloats];
  __shared__ int lanes[kThreads];
  const int tid = threadIdx.x;
  const int64_t runs = (a.C + kS - 1) / kS;
  const int64_t run = blockIdx.x * static_cast<int64_t>(kThreads) + tid;
  lanes[tid] = run < runs ? a.long_lane[run] : -1;
  __syncthreads();
  const int width = a.k + 2;                  // a partial's floats
  const int per_round = kTotalsFloats / width;
  const uint32_t rows0 =
      static_cast<uint32_t>(__cvta_generic_to_shared(rows));
  for (int i = 0; i < kThreads; ++i) {
    const int u = lanes[i];
    if (u < 0) continue;
    const int64_t s = a.starts[u], e = a.starts[u + 1];
    const int64_t groups = (e - s + kS - 1) / kS;
    float total[kColsPerThread];
#pragma unroll
    for (int q = 0; q < kColsPerThread; ++q) total[q] = 0.f;
    for (int64_t g0 = 0; g0 < groups; g0 += per_round) {
      const int n = static_cast<int>(
          groups - g0 < per_round ? groups - g0 : per_round);
      for (int f = tid; f < n * width; f += kThreads) {
        const int r = f / width, col = f - r * width;
        cp_async4(rows0 + 4 * f,
                  a.scratch + (s + (g0 + r) * kS) * width + col, 4u);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kColsPerThread; ++q) {
        const int col = tid + q * kThreads;
        if (col < width) {
          float t = total[q];
#pragma unroll 4
          for (int r = 0; r < n; ++r) t = __fadd_rn(t, rows[r * width + col]);
          total[q] = t;
        }
      }
      __syncthreads();                        // before the next copies
    }
    // the epilogue reads xxp (column k + 1, or gw's column k if binary)
#pragma unroll
    for (int q = 0; q < kColsPerThread; ++q) {
      const int col = tid + q * kThreads;
      if (col < width) rows[col] = total[q];
    }
    __syncthreads();
    const float xxp = rows[kValued ? a.k + 1 : a.k];
    const float vm = __ldg(a.vmask + u);
    for (int col = tid; col < a.k; col += kThreads)
      a.gV[u * a.k + col] = grad_v(a, rows[col], xxp, v_at(a, u, col), vm);
    if (tid == 0) a.gw[u] = rows[a.k];
    __syncthreads();                          // before rows are reused
  }
}

template <int T, int CPL, bool kValued>
cudaError_t launch_sums(const Args& a, int tiles, cudaStream_t st) {
  using G = Team<T, CPL>;
  if (a.C == 0) return cudaSuccess;           // every lane is empty
  const int64_t runs = (a.C + kS - 1) / kS;
  const dim3 grid(static_cast<unsigned int>((runs + G::kPerBlock - 1) /
                                            G::kPerBlock),
                  tiles);
  group_sums<T, CPL, kValued>
      <<<grid, kThreads, sizeof(float) * G::kPerBlock * 2 * G::kStage,
         st>>>(a);
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  lane_totals<kValued><<<static_cast<unsigned int>(
                             (runs + kThreads - 1) / kThreads),
                         kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <int T, int CPL>
cudaError_t launch_sums(const Args& a, int tiles, cudaStream_t st) {
  return a.vals ? launch_sums<T, CPL, true>(a, tiles, st)
                : launch_sums<T, CPL, false>(a, tiles, st);
}

}  // namespace

extern "C" int difacto_fm_chunk_grad(
    const float* p, const float* xv, int64_t ldx, const int32_t* chunk_idx,
    const int32_t* chunk_lane, const float* chunk_vals, const void* V,
    int64_t ldv, int64_t v_bf16, const float* vmask, int32_t* starts,
    int32_t* long_lane, float* scratch, float* gw, float* gV, int64_t B,
    int64_t C, int64_t U, int64_t k, int64_t group, void* stream) {
  // group: the caller's count of chunks a group (ops/fused.py
  // CHUNK_GRAD_GROUP), refused unless it is this build's kS
  if (group != kS) return static_cast<int>(cudaErrorInvalidValue);
  if (U <= 0) return 0;
  if (k <= 0 || B < 0 || C < 0 || B > INT32_MAX || C > INT32_MAX ||
      U >= INT32_MAX || k + 2 > kThreads * kColsPerThread)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.p = p;
  a.xv = xv;
  a.idx = chunk_idx;
  a.lane = chunk_lane;
  a.vals = chunk_vals;
  a.V = V;
  a.vmask = vmask;
  a.starts = starts;
  a.long_lane = long_lane;
  a.scratch = scratch;
  a.gw = gw;
  a.gV = gV;
  a.ldx = ldx;
  a.ldv = ldv;
  a.B = B;
  a.C = C;
  a.U = U;
  a.k = static_cast<int>(k);
  a.v_bf16 = v_bf16 ? 1 : 0;
  const int tiles = static_cast<int>((k + kTile - 1) / kTile);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  lane_starts<<<static_cast<unsigned int>((U + 1 + 255) / 256), 256, 0,
                st>>>(a);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  // a team's lanes: the power of two >= k from 4 to 32, two columns a
  // lane above 32 (at most 32 teams a block: 24.6 KB of stages)
  if (k > 32)
    rc = launch_sums<32, 2>(a, tiles, st);
  else if (k > 16)
    rc = launch_sums<32, 1>(a, tiles, st);
  else if (k > 8)
    rc = launch_sums<16, 1>(a, tiles, st);
  else if (k > 4)
    rc = launch_sums<8, 1>(a, tiles, st);
  else
    rc = launch_sums<4, 1>(a, tiles, st);
  return static_cast<int>(rc);
}
