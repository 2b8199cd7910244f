// Fused-row scatter with the FTRL/AdaGrad epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_scatter_epilogue` (difacto_tpu/ops/fused.py:337),
// the push of every training step. For each j < n_rows with
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
//     written back in the container (fp32, bf16 by round-to-nearest-even,
//     or requantized with fresh per-row scales into words 5/6); the pad
//     lanes [k:h] and [h+k:2h] become zeros. Rows with vmask == 0 keep
//     their embedding lanes bit for bit; the gap lanes [2h:off] of the
//     appended layout are always carried.
//
// Rounding is exact and never contracted: every operation is an explicit
// round-to-nearest intrinsic (__fadd_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn)
// in the order of the JAX source, so `a*b + c` can never become an FMA,
// whatever the build flags; rintf is jnp.round (half to even).
//
// Bound: data movement. Each in-bounds row is read once from `rows` (plus
// its 4 + 4 + 4k bytes of gw/vmask/gV) and written once to the table;
// the arithmetic is ~30 flops per embedding column. Design: one warp per
// row, eight rows per block. The warp stages the row in shared memory with
// 16-byte vectors (the Pallas kernel's VMEM tile), its lanes run the
// AdaGrad columns (a warp-shuffle max gives the requant amax), and the
// new row leaves as 16-byte vectors again, so the table row is touched by
// exactly one coalesced write and no other warp. Slots are unique, so no
// atomics. Offsets are 64-bit: a full-width table is 2^31 bytes. Nothing
// is allocated and nothing synchronises; the launch goes on the caller's
// stream and the return value is cudaGetLastError(), which the wrapper
// (difacto_tpu_torch/ops/fused.py) raises on. Multi-row pipelining and
// TMA are later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

// container of the fused row; int8 and fp8 codes share the int8 container
enum Container : int { kF32 = 0, kBF16 = 1, kInt8 = 2, kFP8 = 3 };

struct Hyper {
  float l1, l2, lr, lr_beta, V_l2, V_lr, V_lr_beta, V_threshold;
};

__device__ __forceinline__ float nan_max(float a, float b) {
  // jnp.max / torch.amax propagate NaN; fmaxf would drop it
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float bf16_to_f32(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

__device__ __forceinline__ uint16_t f32_to_bf16_rne(float f) {
  // torch's round_to_nearest_even (c10/util/BFloat16.h)
  if (f != f) return 0x7FC0u;
  const uint32_t u = __float_as_uint(f);
  return static_cast<uint16_t>((u + (((u >> 16) & 1u) + 0x7FFFu)) >> 16);
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
  // c10's fp8e4m3fn_from_fp32_value: round to nearest even, NaN at and
  // above 480
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

__device__ __forceinline__ uint8_t quant_code(float x, float scale,
                                              int container) {
  const float y = __fdiv_rn(x, scale);
  if (container == kInt8) {
    const float r = fminf(fmaxf(rintf(y), -127.0f), 127.0f);
    return static_cast<uint8_t>(static_cast<int8_t>(r));
  }
  return f32_to_fp8e4m3fn(y);
}

__device__ __forceinline__ float warp_nan_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
scatter_epilogue_kernel(uint8_t* __restrict__ table,
                        const int32_t* __restrict__ slots,
                        const uint8_t* __restrict__ rows,
                        const float* __restrict__ gw,
                        const float* __restrict__ gV,
                        const float* __restrict__ vmask,
                        int64_t capacity, int64_t n_rows, int row_bytes,
                        int k, int h, int off, int container, int epilogue,
                        Hyper hp, int warp_smem) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  if (j >= n_rows) return;
  const int32_t s = slots[j];
  if (s < 0 || static_cast<int64_t>(s) >= capacity) return;
  const int nvec = row_bytes / 16;
  const uint4* src = reinterpret_cast<const uint4*>(
      rows + j * static_cast<int64_t>(row_bytes));
  uint4* dst = reinterpret_cast<uint4*>(
      table + static_cast<int64_t>(s) * row_bytes);
  if (!epilogue) {
    for (int v = lane; v < nvec; v += 32) dst[v] = src[v];
    return;
  }

  uint8_t* buf = smem + warp * warp_smem;          // the staged row
  float* fscr = reinterpret_cast<float*>(buf + row_bytes);  // 2k f32
  for (int v = lane; v < nvec; v += 32)
    reinterpret_cast<uint4*>(buf)[v] = src[v];
  __syncwarp();

  const int esize = container == kF32 ? 4 : (container == kBF16 ? 2 : 1);
  uint32_t* scal = reinterpret_cast<uint32_t*>(buf + off * esize);
  const float w = __uint_as_float(scal[0]);
  const float z = __uint_as_float(scal[1]);
  const float sg = __uint_as_float(scal[2]);
  const uint32_t cnt_bits = scal[3];
  const float cnt = __uint_as_float(cnt_bits);
  const bool live = __uint_as_float(scal[4]) > 0.0f;
  uint32_t sV_bits = scal[5], sVg_bits = scal[6];
  const float sV = __uint_as_float(sV_bits);
  const float sVg = __uint_as_float(sVg_bits);

  // ftrl_w, in the JAX source's operation order
  const float g = __fadd_rn(gw[j], __fmul_rn(hp.l2, w));
  const float sg_new =
      __fsqrt_rn(__fadd_rn(__fmul_rn(sg, sg), __fmul_rn(g, g)));
  const float z_new = __fsub_rn(
      z, __fsub_rn(g, __fmul_rn(__fdiv_rn(__fsub_rn(sg_new, sg), hp.lr), w)));
  const float eta = __fdiv_rn(__fadd_rn(hp.lr_beta, sg_new), hp.lr);
  const float sgn = z_new > 0.0f ? 1.0f : (z_new < 0.0f ? -1.0f : z_new);
  const float w_new =
      fabsf(z_new) <= hp.l1
          ? 0.0f
          : __fdiv_rn(__fsub_rn(z_new, __fmul_rn(sgn, hp.l1)), eta);
  const bool live_new = live || (w_new != 0.0f && cnt > hp.V_threshold);

  if (vmask[j] > 0.0f) {
    const bool quant = container >= kInt8;
    const float* gVj = gV + j * static_cast<int64_t>(k);
    float amax_V = 0.0f, amax_Vg = 0.0f;
    for (int c = lane; c < k; c += 32) {
      const float V = load_lane(buf, c, container, sV);
      const float Vg = load_lane(buf, h + c, container, sVg);
      const float gv = __fadd_rn(gVj[c], __fmul_rn(hp.V_l2, V));
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
        store_lane(buf, c, container, V_new);
        store_lane(buf, h + c, container, Vg_new);
      }
    }
    // pad lanes of both halves become zeros (fuse_vvg pads with zeros);
    // in the in-pad layout the Vg pad ends where the scalars begin
    const int vg_pad_end = min(2 * h, off);
    for (int c = k + lane; c < h; c += 32) {
      for (int b = 0; b < esize; ++b) buf[c * esize + b] = 0;
    }
    for (int c = h + k + lane; c < vg_pad_end; c += 32) {
      for (int b = 0; b < esize; ++b) buf[c * esize + b] = 0;
    }
    if (quant) {
      const float qmax = container == kInt8 ? 127.0f : 448.0f;
      amax_V = warp_nan_max(amax_V);
      amax_Vg = warp_nan_max(amax_Vg);
      const float scale_V = amax_V > 0.0f ? __fdiv_rn(amax_V, qmax) : 1.0f;
      const float scale_Vg = amax_Vg > 0.0f ? __fdiv_rn(amax_Vg, qmax) : 1.0f;
      for (int c = lane; c < k; c += 32) {
        buf[c] = quant_code(fscr[c], scale_V, container);
        buf[h + c] = quant_code(fscr[k + c], scale_Vg, container);
      }
      sV_bits = __float_as_uint(scale_V);
      sVg_bits = __float_as_uint(scale_Vg);
    }
  }
  __syncwarp();  // every lane has read the old scalars
  if (lane == 0) {
    scal[0] = __float_as_uint(w_new);
    scal[1] = __float_as_uint(z_new);
    scal[2] = __float_as_uint(sg_new);
    scal[3] = cnt_bits;
    scal[4] = __float_as_uint(live_new ? 1.0f : 0.0f);
    scal[5] = sV_bits;
    scal[6] = sVg_bits;
    scal[7] = 0u;
  }
  __syncwarp();
  for (int v = lane; v < nvec; v += 32)
    dst[v] = reinterpret_cast<const uint4*>(buf)[v];
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
  // per warp: the staged row, then 2k f32 of requant scratch, 16-aligned
  const int warp_smem =
      epilogue ? static_cast<int>(((row_bytes + 8 * k) + 15) / 16 * 16) : 0;
  const size_t smem = static_cast<size_t>(warp_smem) * kWarpsPerBlock;
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        scatter_epilogue_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const int64_t blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  scatter_epilogue_kernel<<<static_cast<unsigned int>(blocks),
                            kWarpsPerBlock * 32, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(table), slots,
      static_cast<const uint8_t*>(rows), gw, gV, vmask, capacity, n_rows,
      static_cast<int>(row_bytes), static_cast<int>(k), static_cast<int>(h),
      static_cast<int>(off), static_cast<int>(container),
      static_cast<int>(epilogue), hp, warp_smem);
  return static_cast<int>(cudaGetLastError());
}
