// Building blocks shared by the kernels: bf16 packing (all of them, the flat
// convolution K4, conv_flat.cu, included) and the reductions over the four
// threads that share an accumulator row (every attention kernel).
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

__device__ __forceinline__ float group4_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float group4_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace tvs
