// Building blocks shared by the kernels: bf16 packing (all of them, the flat
// convolution K4, conv_flat.cu, included), the reductions over the four
// threads that share a fragment row (every attention kernel), and for the
// biased attention forward K3 (flash_attn_bias_fwd.cu) the mma.sync m16n8k16
// wrapper and the strided global -> shared tile load.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tvs {

__device__ __forceinline__ uint32_t pack_f32x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 8 bf16 (16 bytes) to f32 and back
__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    f[2 * i] = __low2float(h);
    f[2 * i + 1] = __high2float(h);
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack_f32x2(f[0], f[1]), pack_f32x2(f[2], f[3]), pack_f32x2(f[4], f[5]),
                    pack_f32x2(f[6], f[7]));
}

__device__ __forceinline__ uint32_t pack_raw(unsigned short lo, unsigned short hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// c += a * b for one m16n8k16 tile: a is 16x16 (row), b is 16x8 (col), f32 accumulators.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float group4_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float group4_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Copy kRows rows of D bf16 (row r at src + r * row_stride) into shared
// memory with row stride D + 8, by a block of kThreads threads; rows >= valid
// (which may be <= 0) are zero-filled. The 8-element pad makes the fragment
// reads free of bank conflicts.
template <int D, int kRows, int kThreads>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int64_t row_stride, int valid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kStride = D + 8;
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * row_stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * kStride + c * 8) = val;
  }
}

}  // namespace tvs
