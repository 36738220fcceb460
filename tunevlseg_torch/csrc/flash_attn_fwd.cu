// K1: unbiased self-attention forward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the Pallas TPU kernel tunevlseg_tpu/ops/flash_attention.py:
// _forward_batched_heads. It computes the same function,
//
//     o = softmax(q k^T * D^-1/2) v,   keys at index >= t_valid get p = 0,
//
// with the same numerics: scores and the softmax in f32, p = exp(s - m) cast
// to bf16 for the PV product (f32 accumulation), and the denominator the f32
// sum of the UNROUNDED p. The TPU kernel holds each head's whole S x T score
// tile in VMEM; here the keys stream through shared memory in tiles of 64 with
// an online softmax (running row max and row sum in f32), so the rounding of
// p happens against the running max rather than the final one.
//
// Bound at the serving shapes (b64, S = T = 485): vision h12 d64 does
// 4*B*H*S*T*D = 46 GFLOP per layer against 191 MB of q, k, v and o, about
// 242 FLOP/byte; the decoder (h4 d16) has the same ratio. That is just under
// the H100's bf16 ridge of ~295 FLOP/byte, so both the tensor cores and the
// HBM stream matter. The S x T scores never reach HBM: they live in registers
// as mma.sync accumulators, are rescaled and exponentiated there, and are
// re-packed in place as the A operand of the PV product.
//
// When a backward will follow, K1 also writes each row's log-sum-exp in its
// log2 domain, lse2 = row_max + log2(row_sum) (f32, (B, H, S)), which K2
// (flash_attn_bwd.cu) turns into p = exp2(s2 - lse2) without a sweep of its
// own. A null pointer writes nothing; o is the same bits either way.
//
// Design (a first, simple version): one thread block of 4 warps per
// (batch, head, 64 query rows); each warp owns 16 query rows. q, k, v and o
// are read in place in their (B, S, H, D) layout through strides; ragged S
// and T tails and kv_valid are masked in the kernel (zero-filled shared rows,
// -inf scores), with no padding copies. Tensor cores are used through
// mma.sync.m16n8k16 on bf16 fragments. No cp.async pipelining, TMA, wgmma or
// warp specialisation yet.
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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int S, int t_valid, float scale_log2,
                      int64_t q_sb, int64_t q_ss, int64_t q_sh,
                      int64_t k_sb, int64_t k_ss, int64_t k_sh,
                      int64_t v_sb, int64_t v_ss, int64_t v_sh,
                      int64_t o_sb, int64_t o_ss, int64_t o_sh) {
  constexpr int kStride = D + 8;
  constexpr int kDimSteps = D / 16;      // k-steps of the QK^T product
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

  load_tile<D, kBlockM, kThreads>(sQ, q + b * q_sb + h * q_sh + m0 * q_ss, q_ss, S - m0);
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

  float acc[kOutTiles][4];
#pragma unroll
  for (int nt = 0; nt < kOutTiles; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  // Rows g and g + 8 of the warp's 16; scores are kept in the log2 domain.
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};  // this thread's partial sum of unrounded p

  const __nv_bfloat16* kbase = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vbase = v + b * v_sb + h * v_sh;
  const unsigned short* sVraw = reinterpret_cast<const unsigned short*>(sV);

  for (int n0 = 0; n0 < t_valid; n0 += kBlockN) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D, kBlockM, kThreads>(sK, kbase + n0 * k_ss, k_ss, t_valid - n0);
    load_tile<D, kBlockM, kThreads>(sV, vbase + n0 * v_ss, v_ss, t_valid - n0);
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

    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kScoreTiles; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = n0 + nt * 8 + tig * 2 + (i & 1);
        const float x = col < t_valid ? s[nt][i] * scale_log2 : -INFINITY;
        s[nt][i] = x;
        tile_max[i >> 1] = fmaxf(tile_max[i >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // key 0 is always valid, so the running max is finite after tile 0
      const float new_max = fmaxf(row_max[r], group4_max(tile_max[r]));
      corr[r] = exp2f(row_max[r] - new_max);
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

    // p = exp(s - m): summed unrounded, then packed as bf16 A fragments.
    // Score tiles 2j and 2j+1 form k-step j of the PV product.
    uint32_t pa[kKeySteps][4];
#pragma unroll
    for (int nt = 0; nt < kScoreTiles; ++nt) {
      const float p0 = exp2f(s[nt][0] - row_max[0]);
      const float p1 = exp2f(s[nt][1] - row_max[0]);
      const float p2 = exp2f(s[nt][2] - row_max[1]);
      const float p3 = exp2f(s[nt][3] - row_max[1]);
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

  const float denom0 = group4_sum(row_sum[0]);
  const float denom1 = group4_sum(row_sum[1]);
  const int row_a = m0 + r0;
  const int row_b = row_a + 8;
  if (lse != nullptr && tig == 0) {
    float* lrow = lse + (static_cast<int64_t>(b) * gridDim.y + h) * S;
    if (row_a < S) lrow[row_a] = row_max[0] + log2f(denom0);
    if (row_b < S) lrow[row_b] = row_max[1] + log2f(denom1);
  }
  __nv_bfloat16* obase = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int nt = 0; nt < kOutTiles; ++nt) {
    const int col = nt * 8 + tig * 2;
    if (row_a < S)
      *reinterpret_cast<uint32_t*>(obase + row_a * o_ss + col) =
          pack_f32x2(acc[nt][0] / denom0, acc[nt][1] / denom0);
    if (row_b < S)
      *reinterpret_cast<uint32_t*>(obase + row_b * o_ss + col) =
          pack_f32x2(acc[nt][2] / denom1, acc[nt][3] / denom1);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
                   int H, int t_valid, const long long* strides, cudaStream_t stream) {
  const dim3 grid((S + kBlockM - 1) / kBlockM, H, B);
  const float scale_log2 = (1.0f / sqrtf(static_cast<float>(D))) * 1.4426950408889634f;
  flash_attn_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, S, t_valid,
      scale_log2, strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
      strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]);
  return cudaGetLastError();
}

}  // namespace

// q (B, S, H, D), k and v (B, T, H, D), o (B, S, H, D), all bf16 with unit
// stride on D. `strides` holds the (batch, seq, head) strides in elements of
// q, k, v and o, in that order (12 values). Keys at index >= t_valid are
// masked (t_valid = kv_valid, or T). lse is null or f32 (B, H, S), each
// row's log2-domain log-sum-exp. Returns the cudaError_t of the launch.
extern "C" int tvs_flash_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                                  int B, int S, int H, int D, int t_valid,
                                  const long long* strides, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lp = static_cast<float*>(lse);
  switch (D) {
    case 16: return static_cast<int>(launch<16>(q, k, v, o, lp, B, S, H, t_valid, strides, st));
    case 32: return static_cast<int>(launch<32>(q, k, v, o, lp, B, S, H, t_valid, strides, st));
    case 64: return static_cast<int>(launch<64>(q, k, v, o, lp, B, S, H, t_valid, strides, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
