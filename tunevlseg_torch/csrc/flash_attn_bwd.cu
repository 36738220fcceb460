// K2: fused backward of unbiased self-attention for Hopper (sm_90a), bf16.
//
// Replaces the Pallas TPU kernel tunevlseg_tpu/ops/flash_attention.py:
// _backward_batched_heads. From q, k, v and the incoming gradient g alone (no
// residual of the forward beyond q, k, v) it recomputes
//
//     p  = softmax(q k^T * scale),  keys at index >= t_valid get p = 0,
//     dv = p^T g,   dp = g v^T,   delta_i = sum_j p_ij dp_ij,
//     ds = p (dp - delta) * scale,   dq = ds k,   dk = ds^T q,
//
// with the TPU kernel's numerics: scores, softmax, delta and ds in f32; p is
// rounded to bf16 only as the operand of dv, ds only as the operand of dq and
// dk; every product accumulates in f32; outputs are bf16. Masked keys give
// exactly zero dk and dv rows.
//
// The TPU kernel holds four f32 (S x T) tiles of a head in VMEM inside one
// grid cell. An SM cannot (4 * 512 * 512 * 4 B = 4 MB against 227 KB of
// shared memory) and blocks carry nothing to each other, while dq sums over
// keys and dk, dv sum over queries. This version takes two deterministic
// passes, each recomputing the scores in 64 x 64 tiles that never leave
// registers, with no atomics, no f32 gradient scratch and no cast epilogue:
//
//   pass 1 (flash_attn_bwd_dq_kernel): a block owns 64 query rows (16 per
//     warp, q and g held as mma A fragments). A first sweep over the key
//     tiles forms s = q k^T and dp = g v^T and keeps, online, the row max,
//     the row sum of exp(s - max) and the row sum of exp(s - max) * dp; that
//     gives the log-sum-exp and delta = sum_j p dp of each row (f32, written
//     to a (B, H, S) scratch for pass 2). A second sweep recomputes s and dp,
//     forms ds in registers, repacks it as the A operand and accumulates
//     dq += ds k.
//   pass 2 (flash_attn_bwd_dkdv_kernel): a block owns 64 keys (k and v held
//     as A fragments) and loops over the query tiles, computing the
//     TRANSPOSED tiles s^T = k q^T and dp^T = v g^T so that p^T and ds^T come
//     out in the A-operand layout of dv += p^T g and dk += ds^T q.
//
// That is 9 tile products for the 5 of the formula (1.8x the operations);
// the price of determinism and of needing nothing from the forward. Bound at
// the training shapes (b64, S = T = 485): vision h12 d64 needs
// 10*B*H*S*T*D = 116 GFLOP against 7 tensors of 47.7 MB, 346 FLOP/byte,
// above the H100's bf16 ridge of ~295: bound by the tensor cores (117 us at
// 989 TFLOP/s, 100 us by HBM). The decoder shape (h4 d16) has the same ratio.
// The S x T intermediates never reach HBM. Tensor cores are used through
// mma.sync.m16n8k16; no cp.async pipelining, TMA or wgmma yet.
//
// q, k, v, g and the outputs are read and written in place in their
// (B, S, H, D) layout through strides (g is often a strided view); the ragged
// S and T tails and t_valid are masked in the kernel (zero-filled shared
// rows, zero probabilities), with no padding copies.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see tunevlseg_torch/ops/flash_attention.py). Plain C
// entry point, loaded with ctypes.

#include "attn_common.cuh"

namespace {

using namespace tvs;

constexpr int kTile = 64;  // rows per block tile and per streamed tile, 16 per warp
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kColTiles = kTile / 8;   // 8-wide column tiles of a 64-wide score tile
constexpr int kColSteps = kTile / 16;  // k-steps of a product over those 64 columns

// (batch, sequence, head) strides of one tensor, in elements; unit stride on D.
struct Strides {
  int64_t b, s, h;
};

// A fragments (16 rows x D) of rows row0 + g and row0 + g + 8 of a shared tile.
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[D / 16][4], const __nv_bfloat16* tile,
                                             int row0, int g, int tig) {
  constexpr int kStride = D + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* base = tile + (row0 + g) * kStride + kk * 16 + tig * 2;
    a[kk][0] = *reinterpret_cast<const uint32_t*>(base);
    a[kk][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kStride);
    a[kk][2] = *reinterpret_cast<const uint32_t*>(base + 8);
    a[kk][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kStride + 8);
  }
}

// c[row][n] = sum_d A[row][d] * tile[n][d]: the warp's 16 rows (fragments a)
// against the 64 rows of a shared tile, contracted over D.
template <int D>
__device__ __forceinline__ void mma_rows_x_tile_t(float (&c)[kColTiles][4],
                                                  const uint32_t (&a)[D / 16][4],
                                                  const __nv_bfloat16* tile, int g, int tig) {
  constexpr int kStride = D + 8;
#pragma unroll
  for (int nt = 0; nt < kColTiles; ++nt) {
    c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* bp = tile + (nt * 8 + g) * kStride + kk * 16 + tig * 2;
      mma_bf16_16816(c[nt], a[kk], *reinterpret_cast<const uint32_t*>(bp),
                     *reinterpret_cast<const uint32_t*>(bp + 8));
    }
  }
}

// acc[row][d] += sum_n P[row][n] * tile[n][d]: the warp's 16 x 64 operand
// (packed bf16 fragments p) against a 64 x D shared tile.
template <int D>
__device__ __forceinline__ void mma_p_x_tile(float (&acc)[D / 8][4],
                                             const uint32_t (&p)[kColSteps][4],
                                             const __nv_bfloat16* tile, int g, int tig) {
  constexpr int kStride = D + 8;
  const unsigned short* raw = reinterpret_cast<const unsigned short*>(tile);
#pragma unroll
  for (int kk = 0; kk < kColSteps; ++kk) {
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      // B[n][d] = tile[n][d]: two rows n per register, one column d
      const unsigned short* bp = raw + (kk * 16 + tig * 2) * kStride + nt * 8 + g;
      const uint32_t b0 = pack_raw(bp[0], bp[kStride]);
      const uint32_t b1 = pack_raw(bp[8 * kStride], bp[9 * kStride]);
      mma_bf16_16816(acc[nt], p[kk], b0, b1);
    }
  }
}

// Store the warp's 16 x D accumulator as bf16 rows row_a = first + g and
// row_a + 8 of a (rows x D) tensor slice, rows >= limit skipped.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, int64_t row_stride,
                                           const float (&acc)[D / 8][4], int row_a, int limit,
                                           int tig) {
  const int row_b = row_a + 8;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int col = nt * 8 + tig * 2;
    if (row_a < limit)
      *reinterpret_cast<uint32_t*>(base + row_a * row_stride + col) =
          pack_f32x2(acc[nt][0], acc[nt][1]);
    if (row_b < limit)
      *reinterpret_cast<uint32_t*>(base + row_b * row_stride + col) =
          pack_f32x2(acc[nt][2], acc[nt][3]);
  }
}

// Pass 1: dq, and each query row's log2-sum-exp and delta for pass 2.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ g,
                         __nv_bfloat16* __restrict__ dq, float* __restrict__ lse,
                         float* __restrict__ delta, int S, int t_valid, float scale,
                         float scale_log2, Strides qs, Strides ks, Strides vs, Strides gs,
                         Strides dqs) {
  constexpr int kStride = D + 8;
  __shared__ __align__(16) __nv_bfloat16 sQ[kTile * kStride];
  __shared__ __align__(16) __nv_bfloat16 sG[kTile * kStride];
  __shared__ __align__(16) __nv_bfloat16 sK[kTile * kStride];
  __shared__ __align__(16) __nv_bfloat16 sV[kTile * kStride];

  const int m0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / 4;  // fragment row group
  const int tig = lane % 4;  // thread in group

  load_tile<D, kTile, kThreads>(sQ, q + b * qs.b + h * qs.h + m0 * qs.s, qs.s, S - m0);
  load_tile<D, kTile, kThreads>(sG, g + b * gs.b + h * gs.h + m0 * gs.s, gs.s, S - m0);
  __syncthreads();
  uint32_t qa[D / 16][4], ga[D / 16][4];
  load_a_frags<D>(qa, sQ, warp * 16, grp, tig);
  load_a_frags<D>(ga, sG, warp * 16, grp, tig);

  const __nv_bfloat16* kbase = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vbase = v + b * vs.b + h * vs.h;

  // Sweep 1: online row max, sum of e = exp2(x - max) and sum of e * dp, for
  // rows grp and grp + 8 of the warp's 16; scores in the log2 domain.
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};
  float row_num[2] = {0.f, 0.f};
  for (int n0 = 0; n0 < t_valid; n0 += kTile) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D, kTile, kThreads>(sK, kbase + n0 * ks.s, ks.s, t_valid - n0);
    load_tile<D, kTile, kThreads>(sV, vbase + n0 * vs.s, vs.s, t_valid - n0);
    __syncthreads();

    float s[kColTiles][4], dp[kColTiles][4];
    mma_rows_x_tile_t<D>(s, qa, sK, grp, tig);
    mma_rows_x_tile_t<D>(dp, ga, sV, grp, tig);

    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kColTiles; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = n0 + nt * 8 + tig * 2 + (i & 1);
        const float x = col < t_valid ? s[nt][i] * scale_log2 : -INFINITY;
        s[nt][i] = x;
        tile_max[i >> 1] = fmaxf(tile_max[i >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // key 0 is always valid, so the running max is finite after tile 0
      const float new_max = fmaxf(row_max[r], group4_max(tile_max[r]));
      const float corr = exp2f(row_max[r] - new_max);
      row_max[r] = new_max;
      row_sum[r] *= corr;
      row_num[r] *= corr;
    }
#pragma unroll
    for (int nt = 0; nt < kColTiles; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = exp2f(s[nt][i] - row_max[i >> 1]);  // 0 at masked keys
        row_sum[i >> 1] += e;
        row_num[i >> 1] += e * dp[nt][i];
      }
    }
  }

  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float total = group4_sum(row_sum[r]);
    row_lse[r] = row_max[r] + log2f(total);
    row_delta[r] = group4_sum(row_num[r]) / total;
    const int row = m0 + warp * 16 + grp + r * 8;
    if (tig == 0 && row < S) {
      const int64_t idx = (static_cast<int64_t>(b) * gridDim.y + h) * S + row;
      lse[idx] = row_lse[r];
      delta[idx] = row_delta[r];
    }
  }

  // Sweep 2: ds = p (dp - delta) scale in registers, dq += ds k.
  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  for (int n0 = 0; n0 < t_valid; n0 += kTile) {
    __syncthreads();
    load_tile<D, kTile, kThreads>(sK, kbase + n0 * ks.s, ks.s, t_valid - n0);
    load_tile<D, kTile, kThreads>(sV, vbase + n0 * vs.s, vs.s, t_valid - n0);
    __syncthreads();

    float s[kColTiles][4], dp[kColTiles][4];
    mma_rows_x_tile_t<D>(s, qa, sK, grp, tig);
    mma_rows_x_tile_t<D>(dp, ga, sV, grp, tig);

    // Score tiles 2j and 2j+1 form k-step j of the ds k product.
    uint32_t dsa[kColSteps][4];
#pragma unroll
    for (int nt = 0; nt < kColTiles; ++nt) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = n0 + nt * 8 + tig * 2 + (i & 1);
        const int r = i >> 1;
        const float p = col < t_valid ? exp2f(s[nt][i] * scale_log2 - row_lse[r]) : 0.f;
        ds[i] = p * (dp[nt][i] - row_delta[r]) * scale;
      }
      dsa[nt / 2][(nt % 2) * 2 + 0] = pack_f32x2(ds[0], ds[1]);
      dsa[nt / 2][(nt % 2) * 2 + 1] = pack_f32x2(ds[2], ds[3]);
    }
    mma_p_x_tile<D>(acc, dsa, sK, grp, tig);
  }

  store_rows<D>(dq + b * dqs.b + h * dqs.h, dqs.s, acc, m0 + warp * 16 + grp, S, tig);
}

// Pass 2: dk and dv of 64 keys, from transposed score tiles.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ g, __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, const float* __restrict__ lse,
                           const float* __restrict__ delta, int S, int T, int t_valid,
                           float scale, float scale_log2, Strides qs, Strides ks, Strides vs,
                           Strides gs, Strides dks, Strides dvs) {
  constexpr int kStride = D + 8;
  __shared__ __align__(16) __nv_bfloat16 sK[kTile * kStride];
  __shared__ __align__(16) __nv_bfloat16 sV[kTile * kStride];
  __shared__ __align__(16) __nv_bfloat16 sQ[kTile * kStride];
  __shared__ __align__(16) __nv_bfloat16 sG[kTile * kStride];
  __shared__ float sLse[kTile];
  __shared__ float sDelta[kTile];

  const int n0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / 4;
  const int tig = lane % 4;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    dk_acc[nt][0] = dk_acc[nt][1] = dk_acc[nt][2] = dk_acc[nt][3] = 0.f;
    dv_acc[nt][0] = dv_acc[nt][1] = dv_acc[nt][2] = dv_acc[nt][3] = 0.f;
  }

  // A tile of masked keys only keeps its zero accumulators (block-uniform test).
  if (n0 < t_valid) {
    load_tile<D, kTile, kThreads>(sK, k + b * ks.b + h * ks.h + n0 * ks.s, ks.s, t_valid - n0);
    load_tile<D, kTile, kThreads>(sV, v + b * vs.b + h * vs.h + n0 * vs.s, vs.s, t_valid - n0);
    __syncthreads();
    uint32_t ka[D / 16][4], va[D / 16][4];
    load_a_frags<D>(ka, sK, warp * 16, grp, tig);
    load_a_frags<D>(va, sV, warp * 16, grp, tig);

    const __nv_bfloat16* qbase = q + b * qs.b + h * qs.h;
    const __nv_bfloat16* gbase = g + b * gs.b + h * gs.h;
    const int64_t stat_base = (static_cast<int64_t>(b) * gridDim.y + h) * S;
    const int key_a = n0 + warp * 16 + grp;  // this thread's keys: key_a and key_a + 8

    for (int m0 = 0; m0 < S; m0 += kTile) {
      __syncthreads();  // every warp is done with the previous query tile
      load_tile<D, kTile, kThreads>(sQ, qbase + m0 * qs.s, qs.s, S - m0);
      load_tile<D, kTile, kThreads>(sG, gbase + m0 * gs.s, gs.s, S - m0);
      if (threadIdx.x < kTile) {
        const int row = m0 + threadIdx.x;
        sLse[threadIdx.x] = row < S ? lse[stat_base + row] : 0.f;
        sDelta[threadIdx.x] = row < S ? delta[stat_base + row] : 0.f;
      }
      __syncthreads();

      // st[key][query] = k q^T, dpt[key][query] = v g^T
      float st[kColTiles][4], dpt[kColTiles][4];
      mma_rows_x_tile_t<D>(st, ka, sQ, grp, tig);
      mma_rows_x_tile_t<D>(dpt, va, sG, grp, tig);

      // Query tiles 2j and 2j+1 form k-step j of the products over queries.
      uint32_t pa[kColSteps][4], dsa[kColSteps][4];
#pragma unroll
      for (int nt = 0; nt < kColTiles; ++nt) {
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qcol = nt * 8 + tig * 2 + (i & 1);
          const int key = key_a + (i >> 1) * 8;
          const bool live = key < t_valid && m0 + qcol < S;
          p[i] = live ? exp2f(st[nt][i] * scale_log2 - sLse[qcol]) : 0.f;
          ds[i] = p[i] * (dpt[nt][i] - sDelta[qcol]) * scale;
        }
        pa[nt / 2][(nt % 2) * 2 + 0] = pack_f32x2(p[0], p[1]);
        pa[nt / 2][(nt % 2) * 2 + 1] = pack_f32x2(p[2], p[3]);
        dsa[nt / 2][(nt % 2) * 2 + 0] = pack_f32x2(ds[0], ds[1]);
        dsa[nt / 2][(nt % 2) * 2 + 1] = pack_f32x2(ds[2], ds[3]);
      }
      mma_p_x_tile<D>(dv_acc, pa, sG, grp, tig);
      mma_p_x_tile<D>(dk_acc, dsa, sQ, grp, tig);
    }
  }

  const int row_a = n0 + warp * 16 + grp;
  store_rows<D>(dk + b * dks.b + h * dks.h, dks.s, dk_acc, row_a, T, tig);
  store_rows<D>(dv + b * dvs.b + h * dvs.h, dvs.s, dv_acc, row_a, T, tig);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
                   void* dv, float* lse, float* delta, int B, int S, int T, int H, int t_valid,
                   const long long* st, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const float scale_log2 = scale * 1.4426950408889634f;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]}, vs{st[6], st[7], st[8]},
      gs{st[9], st[10], st[11]}, dqs{st[12], st[13], st[14]}, dks{st[15], st[16], st[17]},
      dvs{st[18], st[19], st[20]};
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(k);
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(v);
  const __nv_bfloat16* gp = static_cast<const __nv_bfloat16*>(g);

  const dim3 grid_q((S + kTile - 1) / kTile, H, B);
  flash_attn_bwd_dq_kernel<D><<<grid_q, kThreads, 0, stream>>>(
      qp, kp, vp, gp, static_cast<__nv_bfloat16*>(dq), lse, delta, S, t_valid, scale, scale_log2,
      qs, ks, vs, gs, dqs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid_k((T + kTile - 1) / kTile, H, B);
  flash_attn_bwd_dkdv_kernel<D><<<grid_k, kThreads, 0, stream>>>(
      qp, kp, vp, gp, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), lse, delta,
      S, T, t_valid, scale, scale_log2, qs, ks, vs, gs, dks, dvs);
  return cudaGetLastError();
}

}  // namespace

// q, g, dq (B, S, H, D) and k, v, dk, dv (B, T, H, D), all bf16 with unit
// stride on D and 16-byte aligned rows; lse and delta are f32 scratch of
// B * H * S elements each. `strides` holds the (batch, seq, head) strides in
// elements of q, k, v, g, dq, dk and dv, in that order (21 values). Keys at
// index >= t_valid are masked (t_valid = kv_valid, or T). Both passes are
// enqueued on `stream`; returns the cudaError_t of the first failed launch.
extern "C" int tvs_flash_attn_bwd(const void* q, const void* k, const void* v, const void* g,
                                  void* dq, void* dk, void* dv, void* lse, void* delta, int B,
                                  int S, int T, int H, int D, int t_valid,
                                  const long long* strides, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lp = static_cast<float*>(lse);
  float* dp = static_cast<float*>(delta);
  switch (D) {
    case 16:
      return static_cast<int>(
          launch<16>(q, k, v, g, dq, dk, dv, lp, dp, B, S, T, H, t_valid, strides, st));
    case 32:
      return static_cast<int>(
          launch<32>(q, k, v, g, dq, dk, dv, lp, dp, B, S, T, H, t_valid, strides, st));
    case 64:
      return static_cast<int>(
          launch<64>(q, k, v, g, dq, dk, dv, lp, dp, B, S, T, H, t_valid, strides, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
