// K4: stride-1 k x k "same" convolution on the flat guard-banded layout for
// Hopper (sm_90a), bf16 in / bf16 out, with a fused epilogue.
//
// Replaces the Pallas TPU kernel tunevlseg_tpu/ops/conv_pallas.py:
// _conv_flat_pallas. It computes the same function. Activations are
// (B, ROWS, C) with pixel (h, w) of the zero-padded (Hp, Wp) plane at row
// MB + h*Wp + w, so tap (dy, dx) of the convolution is the constant row offset
// (dy-r)*Wp + (dx-r), and
//
//     acc[m, o] = sum_t sum_c x[m + off_t, c] * W[t, c, o]          (f32)
//     out[m, o] = valid(m) ? relu(acc * scale[o] + offset[o] + residual[m, o]) : 0
//
// with the epilogue in f32 in that order, one rounding to bf16, and every row
// written: guard bands and the r-ring of the plane are exact zeros, because
// the next convolution's taps read them.
//
// The TPU kernel walks bands of MB rows in order, fetches halo bands around
// each, and (for C < 128) copies an im2col patch matrix in VMEM so that one
// deep product fills its 128-deep matrix unit. None of that carries over.
// Here the convolution is an implicit GEMM: a block owns a tile of BM flat
// rows x BN output channels of one image; for each tap it reads the SAME rows
// shifted by the tap's offset straight from global memory (no halo, no
// im2col scratch, no band grid), steps over C in chunks of 32, and accumulates
// with mma.sync.m16n8k16 in f32 registers. Tiles that hold no pixel row
// (guard bands: up to two thirds of ROWS at 13 x 13) only store zeros. The
// tiles do not depend on the spec's MB / QB, which on this card only fix ROWS
// and the guard size. Shifted reads of the first and last pixel tile reach
// into the guard bands (lead <= MB keeps the rows a pixel needs inside the
// tensor); rows outside [0, ROWS), which only masked rows ask for, are
// zero-filled.
//
// Bound: the 3 x 3 convolutions of the RN50 stages do 2*B*H*W*9*C*Cout =
// 51 GFLOP each at b64, 416^2 against < 0.4 GB, far above the card's ridge:
// bound by the tensor cores. The stem (C = 32) and the 1 x 1 convolutions that
// widen to 4 * planes are bound by bytes. Neighbouring N-blocks of one row
// tile run side by side (blockIdx.x walks Cout), so a row tile that several
// blocks need comes from L2 after its first read, and so do the k*k shifted
// re-reads of it.
//
// Design (a first, simple version): 8 warps; block tile 256 x 32, 128 x 64 or
// 128 x 128 by Cout; x and W chunks go to shared memory with cp.async
// (16 bytes a thread, zero fill for what lies outside), two stages, so the
// next chunk loads while this one multiplies. The weight comes as
// (Cout, k*k*C), so both operands are read as K-contiguous rows and the
// fragments are plain 32-bit shared loads from rows padded to 40 elements
// (free of bank conflicts). No wgmma, TMA or warp specialisation yet.
//
// Limits, checked here and by the wrapper: C and Cout multiples of 8 (16-byte
// rows), k odd with k / 2 <= r, contiguous tensors.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see tunevlseg_torch/ops/build.py). Plain C entry point,
// loaded with ctypes.

#include "attn_common.cuh"

namespace {

using namespace tvs;

constexpr int kBK = 32;           // input channels per shared-memory chunk
constexpr int kStride = kBK + 8;  // padded shared row
constexpr int kChunks = kBK / 8;  // 16-byte pieces per row
constexpr int kThreads = 256;
constexpr int kStages = 2;

struct ConvParams {
  const __nv_bfloat16* x;         // (B, rows, C)
  const __nv_bfloat16* w;         // (Cout, k*k*C)
  const float* scale;             // (Cout)
  const float* offset;            // (Cout)
  const __nv_bfloat16* residual;  // (B, rows, Cout) or null
  __nv_bfloat16* out;             // (B, rows, Cout)
  int rows, C, Cout, k, wp, hp, r, mb, relu;
};

// 16 bytes global -> shared; nothing is read and zeros are written if !pred.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool pred) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(kThreads) conv_flat_kernel(const ConvParams p) {
  static_assert(WM * WN * 32 == kThreads, "8 warps");
  constexpr int kWarpM = BM / WM;  // rows per warp
  constexpr int kWarpN = BN / WN;  // output channels per warp
  constexpr int MT = kWarpM / 16;
  constexpr int NT = kWarpN / 8;
  static_assert(kWarpM % 16 == 0 && kWarpN % 8 == 0, "warp tile");

  __shared__ __align__(16) __nv_bfloat16 sA[kStages][BM * kStride];
  __shared__ __align__(16) __nv_bfloat16 sB[kStages][BN * kStride];

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int64_t img = static_cast<int64_t>(blockIdx.z) * p.rows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tig = lane % 4;
  const int wrow = (warp / WN) * kWarpM;
  const int wcol = (warp % WN) * kWarpN;

  // pixel rows lie in [first_valid, last_valid]; a tile outside is all zeros
  const int lead = p.r * p.wp + p.r;
  const int first_valid = p.mb + lead;
  const int last_valid = p.mb + p.hp * p.wp - 1 - lead;
  if (m0 > last_valid || m0 + BM <= first_valid) {
    constexpr int kPieces = BN / 8;
    for (int i = threadIdx.x; i < BM * kPieces; i += kThreads) {
      const int row = m0 + i / kPieces;
      const int col = n0 + (i % kPieces) * 8;
      if (row < p.rows && col < p.Cout)
        *reinterpret_cast<uint4*>(p.out + (img + row) * p.Cout + col) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  const int k2 = p.k * p.k;
  const int rk = p.k / 2;
  const int nchunks = (p.C + kBK - 1) / kBK;
  const int iters = k2 * nchunks;
  const int64_t w_row = static_cast<int64_t>(k2) * p.C;

  // chunk `it` = (tap, 32 input channels): the tile's rows shifted by the
  // tap's offset, and the matching 32 columns of BN weight rows
  auto load = [&](int stage, int it) {
    const int tap = it / nchunks;
    const int c0 = (it - tap * nchunks) * kBK;
    const int off = (tap / p.k - rk) * p.wp + (tap % p.k - rk);
    for (int i = threadIdx.x; i < BM * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int c = (i % kChunks) * 8;
      const int row = m0 + r + off;
      const bool ok = row >= 0 && row < p.rows && c0 + c < p.C;
      const __nv_bfloat16* src = ok ? p.x + (img + row) * p.C + c0 + c : p.x;
      cp_async_16(&sA[stage][r * kStride + c], src, ok);
    }
    for (int i = threadIdx.x; i < BN * kChunks; i += kThreads) {
      const int n = i / kChunks;
      const int c = (i % kChunks) * 8;
      const bool ok = n0 + n < p.Cout && c0 + c < p.C;
      const __nv_bfloat16* src =
          ok ? p.w + (n0 + n) * w_row + static_cast<int64_t>(tap) * p.C + c0 + c : p.w;
      cp_async_16(&sB[stage][n * kStride + c], src, ok);
    }
    cp_async_commit();
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  load(0, 0);
  for (int it = 0; it < iters; ++it) {
    if (it + 1 < iters) {
      load((it + 1) & 1, it + 1);  // its stage was released by the last barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* a = sA[it & 1];
    const __nv_bfloat16* bs = sB[it & 1];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const __nv_bfloat16* base = a + (wrow + mt * 16 + g) * kStride + kk * 16 + tig * 2;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(base);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kStride);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(base + 8);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kStride + 8);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* kb = bs + (wcol + nt * 8 + g) * kStride + kk * 16 + tig * 2;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kb);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kb + 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16_16816(acc[mt][nt], af[mt], b0, b1);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  // epilogue in f32: scale * acc + offset, + residual, ReLU, validity mask
  int row_of[MT][2];
  bool valid[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wrow + mt * 16 + g + half * 8;
      row_of[mt][half] = row;
      const int pp = row - p.mb;  // index in the padded plane
      bool ok = false;
      if (pp >= 0) {
        const int hh = pp / p.wp;
        const int ww = pp - hh * p.wp;
        ok = hh >= p.r && hh < p.hp - p.r && ww >= p.r && ww < p.wp - p.r;
      }
      valid[mt][half] = ok;
    }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = n0 + wcol + nt * 8 + tig * 2;
    if (col >= p.Cout) continue;
    const float s0 = __ldg(p.scale + col), s1 = __ldg(p.scale + col + 1);
    const float o0 = __ldg(p.offset + col), o1 = __ldg(p.offset + col + 1);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row_of[mt][half];
        if (row >= p.rows) continue;
        const int64_t at = (img + row) * p.Cout + col;
        float v0 = 0.f, v1 = 0.f;
        if (valid[mt][half]) {
          v0 = acc[mt][nt][half * 2] * s0 + o0;
          v1 = acc[mt][nt][half * 2 + 1] * s1 + o1;
          if (p.residual != nullptr) {
            const __nv_bfloat162 res = *reinterpret_cast<const __nv_bfloat162*>(p.residual + at);
            v0 += __low2float(res);
            v1 += __high2float(res);
          }
          if (p.relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
        }
        *reinterpret_cast<uint32_t*>(p.out + at) = pack_f32x2(v0, v1);
      }
  }
}

template <int BM, int BN, int WM, int WN>
cudaError_t launch(const ConvParams& p, int B, cudaStream_t stream) {
  const dim3 grid((p.Cout + BN - 1) / BN, (p.rows + BM - 1) / BM, B);
  conv_flat_kernel<BM, BN, WM, WN><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x (B, rows, C), w (Cout, k*k*C) with the taps dy-major, then dx, then C,
// residual (B, rows, Cout) or null, out (B, rows, Cout): bf16, contiguous;
// scale and offset f32 (Cout). (wp, hp, r, mb) are the flat spec's padded
// width and height, ring radius and guard height. Returns the cudaError_t of
// the launch.
extern "C" int tvs_conv_flat(const void* x, const void* w, const void* scale, const void* offset,
                             const void* residual, void* out, int B, int rows, int C, int Cout,
                             int k, int wp, int hp, int r, int mb, int relu, void* stream) {
  if (C <= 0 || Cout <= 0 || C % 8 != 0 || Cout % 8 != 0 || k % 2 != 1 || k / 2 > r || B <= 0 ||
      rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  ConvParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.scale = static_cast<const float*>(scale);
  p.offset = static_cast<const float*>(offset);
  p.residual = static_cast<const __nv_bfloat16*>(residual);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.rows = rows;
  p.C = C;
  p.Cout = Cout;
  p.k = k;
  p.wp = wp;
  p.hp = hp;
  p.r = r;
  p.mb = mb;
  p.relu = relu;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Cout <= 32) return static_cast<int>(launch<256, 32, 8, 1>(p, B, st));
  if (Cout <= 64) return static_cast<int>(launch<128, 64, 4, 2>(p, B, st));
  return static_cast<int>(launch<128, 128, 4, 2>(p, B, st));
}
