// K3: biased / cross-attention forward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the Pallas TPU kernel tunevlseg_tpu/ops/flash_attention.py:
// _forward. It computes the same function,
//
//     o = softmax(q k^T * D^-1/2 + bias) v,   keys at index >= t_valid get p = 0,
//
// for q (B, S, H, D) against k, v (B, T, H, D) with S != T allowed and an
// optional f32 bias broadcastable to (B, H, S, T), with the same numerics:
// scores, the bias add and the softmax in f32, p = exp(s - m) cast to bf16 for
// the PV product (f32 accumulation), and the denominator the f32 sum of the
// UNROUNDED p. Its users are short: the text towers' causal + padding
// attention (S = T = 77) and the CRIS decoder's cross-attention from 676
// visual tokens into 77 text tokens with a key-padding bias.
//
// The TPU kernel folds (B, S, H, D) to (B*H, S, D), pads D to 64 and T to 128
// and materialises the bias at (B*H, S, T) in HBM (107 MB of f32 at the cross
// shape). None of that is carried over: q, k, v and o are read in place
// through their strides, and the bias is read in place through ITS strides,
// with stride 0 on every broadcast dimension, so a (B, 1, 1, T) key-padding
// bias costs B*T floats of traffic, served from L2 after the first block.
//
// Bound at the path's shapes: the cross shape (b64, S 676, T 77, h8, d64) does
// 4*B*H*S*T*D = 6.8 GFLOP against 98 MB of q, k, v, o and bias, 70 FLOP/byte:
// under the H100's bf16 ridge of ~295, so the HBM stream of q and o bounds it.
// The text shape (U rows of 77 tokens) is a few hundred KB: launch-bound.
// The S x T scores never reach HBM: they live in registers as mma.sync
// accumulators, get the bias added, are exponentiated there and re-packed in
// place as the A operand of the PV product.
//
// Design (a first, simple version, the structure of K1): one thread block of
// 4 warps per (batch, head, 64 query rows), each warp owning 16 query rows;
// keys stream through shared memory in tiles of 64 (T = 77 is two tiles) with
// an online softmax. Masking: bias entries are dtype-min or, where a causal
// and a padding mask add up, -inf, and columns >= t_valid are -inf. The
// softmax runs in the natural domain, exp2((x - m) * log2 e), so that a row
// whose entries are all dtype-min keeps the TPU kernel's result (uniform p);
// a running max of -inf is replaced by 0 in the rescale and the exponent, so
// -inf - -inf never appears. Ragged S and T tails are zero-filled shared rows
// whose scores are masked (columns) or whose stores are skipped (rows).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see tunevlseg_torch/ops/flash_attention.py). Plain C
// entry point, loaded with ctypes.

#include "attn_common.cuh"

namespace {

using namespace tvs;

constexpr int kBlockM = 64;  // query rows per block, 16 per warp
constexpr int kBlockN = 64;  // keys per shared-memory tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  int64_t q[3], k[3], v[3], o[3];  // (batch, seq, head) in elements
  int64_t bias[4];                 // (batch, head, query, key) in elements
};

template <int D, bool kHasBias>
__global__ void __launch_bounds__(kThreads)
biased_attn_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                       __nv_bfloat16* __restrict__ o, int S, int t_valid, float scale,
                       Strides st) {
  constexpr int kStride = D + 8;
  constexpr int kDimSteps = D / 16;        // k-steps of the QK^T product
  constexpr int kKeySteps = kBlockN / 16;  // k-steps of the PV product
  constexpr int kScoreTiles = kBlockN / 8;
  constexpr int kOutTiles = D / 8;

  __shared__ __align__(16) __nv_bfloat16 sQ[kBlockM * kStride];
  __shared__ __align__(16) __nv_bfloat16 sK[kBlockN * kStride];
  __shared__ __align__(16) __nv_bfloat16 sV[kBlockN * kStride];

  const int m0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;    // fragment row group
  const int tig = lane % 4;  // thread in group

  load_tile<D, kBlockM, kThreads>(sQ, q + b * st.q[0] + h * st.q[2] + m0 * st.q[1], st.q[1],
                                  S - m0);
  __syncthreads();

  // A fragments of this warp's 16 query rows, kept in registers throughout.
  uint32_t qa[kDimSteps][4];
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int kk = 0; kk < kDimSteps; ++kk) {
    const __nv_bfloat16* base = sQ + r0 * kStride + kk * 16 + tig * 2;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(base);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kStride);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(base + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kStride + 8);
  }

  // The two query rows this thread holds scores of, and their bias rows.
  const int rows[2] = {m0 + r0, m0 + r0 + 8};
  const float* bias_row[2] = {nullptr, nullptr};
  if (kHasBias) {
    const float* bias_bh = bias + b * st.bias[0] + h * st.bias[1];
    bias_row[0] = bias_bh + rows[0] * st.bias[2];
    bias_row[1] = bias_bh + rows[1] * st.bias[2];
  }

  float acc[kOutTiles][4];
#pragma unroll
  for (int nt = 0; nt < kOutTiles; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};  // this thread's partial sum of unrounded p

  const __nv_bfloat16* kbase = k + b * st.k[0] + h * st.k[2];
  const __nv_bfloat16* vbase = v + b * st.v[0] + h * st.v[2];
  const unsigned short* sVraw = reinterpret_cast<const unsigned short*>(sV);

  for (int n0 = 0; n0 < t_valid; n0 += kBlockN) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D, kBlockN, kThreads>(sK, kbase + n0 * st.k[1], st.k[1], t_valid - n0);
    load_tile<D, kBlockN, kThreads>(sV, vbase + n0 * st.v[1], st.v[1], t_valid - n0);
    __syncthreads();

    float s[kScoreTiles][4];
#pragma unroll
    for (int nt = 0; nt < kScoreTiles; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kDimSteps; ++kk) {
        const __nv_bfloat16* kb = sK + (nt * 8 + g) * kStride + kk * 16 + tig * 2;
        mma_bf16_16816(s[nt], qa[kk], *reinterpret_cast<const uint32_t*>(kb),
                       *reinterpret_cast<const uint32_t*>(kb + 8));
      }
    }

    // x = s * scale + bias in f32; columns >= t_valid at -inf
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kScoreTiles; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = n0 + nt * 8 + tig * 2 + (i & 1);
        const int r = i >> 1;
        float x = -INFINITY;
        if (col < t_valid) {
          x = s[nt][i] * scale;
          if (kHasBias && rows[r] < S) x += bias_row[r][col * st.bias[3]];
        }
        s[nt][i] = x;
        tile_max[r] = fmaxf(tile_max[r], x);
      }
    }
    float safe_max[2];
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float new_max = fmaxf(row_max[r], group4_max(tile_max[r]));
      // a row with every key so far at -inf: shift by 0, so that p = 0 and
      // no -inf - -inf appears
      safe_max[r] = new_max == -INFINITY ? 0.f : new_max;
      corr[r] = exp2f((row_max[r] - safe_max[r]) * kLog2e);
      row_max[r] = new_max;
      row_sum[r] *= corr[r];
    }
#pragma unroll
    for (int nt = 0; nt < kOutTiles; ++nt) {
      acc[nt][0] *= corr[0];
      acc[nt][1] *= corr[0];
      acc[nt][2] *= corr[1];
      acc[nt][3] *= corr[1];
    }

    // p = exp(x - m): summed unrounded, then packed as bf16 A fragments.
    // Score tiles 2j and 2j+1 form k-step j of the PV product.
    uint32_t pa[kKeySteps][4];
#pragma unroll
    for (int nt = 0; nt < kScoreTiles; ++nt) {
      const float p0 = exp2f((s[nt][0] - safe_max[0]) * kLog2e);
      const float p1 = exp2f((s[nt][1] - safe_max[0]) * kLog2e);
      const float p2 = exp2f((s[nt][2] - safe_max[1]) * kLog2e);
      const float p3 = exp2f((s[nt][3] - safe_max[1]) * kLog2e);
      row_sum[0] += p0 + p1;
      row_sum[1] += p2 + p3;
      pa[nt / 2][(nt % 2) * 2 + 0] = pack_f32x2(p0, p1);
      pa[nt / 2][(nt % 2) * 2 + 1] = pack_f32x2(p2, p3);
    }

#pragma unroll
    for (int kk = 0; kk < kKeySteps; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kOutTiles; ++nt) {
        // B[key][dim] = V[key][dim]: two keys per register, one dim column
        const unsigned short* vb = sVraw + (kk * 16 + tig * 2) * kStride + nt * 8 + g;
        const uint32_t b0 = pack_raw(vb[0], vb[kStride]);
        const uint32_t b1 = pack_raw(vb[8 * kStride], vb[9 * kStride]);
        mma_bf16_16816(acc[nt], pa[kk], b0, b1);
      }
    }
  }

  const float denom[2] = {group4_sum(row_sum[0]), group4_sum(row_sum[1])};
  __nv_bfloat16* obase = o + b * st.o[0] + h * st.o[2];
#pragma unroll
  for (int nt = 0; nt < kOutTiles; ++nt) {
    const int col = nt * 8 + tig * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] < S)
        *reinterpret_cast<uint32_t*>(obase + rows[r] * st.o[1] + col) =
            pack_f32x2(acc[nt][2 * r] / denom[r], acc[nt][2 * r + 1] / denom[r]);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, void* o, int B,
                   int S, int H, int t_valid, const long long* strides,
                   const long long* bias_strides, cudaStream_t stream) {
  const dim3 grid((S + kBlockM - 1) / kBlockM, H, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  for (int i = 0; i < 4; ++i) st.bias[i] = bias ? bias_strides[i] : 0;
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  if (bias)
    biased_attn_fwd_kernel<D, true><<<grid, kThreads, 0, stream>>>(
        qp, kp, vp, static_cast<const float*>(bias), op, S, t_valid, scale, st);
  else
    biased_attn_fwd_kernel<D, false><<<grid, kThreads, 0, stream>>>(qp, kp, vp, nullptr, op, S,
                                                                    t_valid, scale, st);
  return cudaGetLastError();
}

}  // namespace

// q and o (B, S, H, D), k and v (B, T, H, D), all bf16 with unit stride on D.
// `strides` holds the (batch, seq, head) strides in elements of q, k, v and o,
// in that order (12 values). `bias` is null or f32, read as (B, H, S, T)
// through `bias_strides` (4 values in elements, 0 on a broadcast dimension).
// Keys at index >= t_valid are masked (t_valid = kv_valid, or T). Returns the
// cudaError_t of the launch.
extern "C" int tvs_biased_attn_fwd(const void* q, const void* k, const void* v, const void* bias,
                                   void* o, int B, int S, int H, int D, int t_valid,
                                   const long long* strides, const long long* bias_strides,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return static_cast<int>(
          launch<16>(q, k, v, bias, o, B, S, H, t_valid, strides, bias_strides, st));
    case 32:
      return static_cast<int>(
          launch<32>(q, k, v, bias, o, B, S, H, t_valid, strides, bias_strides, st));
    case 64:
      return static_cast<int>(
          launch<64>(q, k, v, bias, o, B, S, H, t_valid, strides, bias_strides, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
