// K2: fused backward of unbiased self-attention for Hopper (sm_90a), bf16.
//
// Replaces the Pallas TPU kernel tunevlseg_tpu/ops/flash_attention.py:
// _backward_batched_heads. It computes the gradient of
//
//     o = softmax(q k^T * scale) v,   keys at index >= t_valid get p = 0,
//
// from q, k, v, the incoming gradient g and one residual of the forward (K1,
// flash_attn_fwd.cu): each row's log-sum-exp in the log2 domain, lse2 =
// max_j s2_ij + log2 sum_j exp2(s2_ij - max), s2 = s * scale * log2(e). With it
//
//     p  = exp2(s2 - lse2),   dv = p^T g,   dp = g v^T,
//     delta_i = sum_j p_ij dp_ij,   ds = p (dp - delta) * scale,
//     dq = ds k,   dk = ds^T q.
//
// Scores, p, delta and ds are f32; p is rounded to bf16 only as the operand
// of dv, ds only as the operand of dq and dk; every product accumulates in
// f32; outputs are bf16. Keys at or beyond t_valid give exactly zero dk and dv
// rows. (delta = g . o from the forward's bf16 output, the FlashAttention-2
// recipe, would spare two tile products, but measured on the card it moved dq
// and dk up to 5.7e-3 of their largest value from the exact gradient, past
// the bound of 5e-3 that the sum of p dp keeps: PERF.md, section 6.)
//
// The TPU kernel holds four f32 (S x T) tiles of a head in VMEM inside one
// grid cell. An SM cannot (4 MB at 512 x 512 against 227 KB of shared memory)
// and blocks carry nothing to each other, while dq sums over keys and dk, dv
// over queries. One C call enqueues two kernels, deterministic (no atomics, no
// f32 gradient scratch):
//
//   1. flash_attn_bwd_dq_kernel: a block owns 192 query rows, 64 per consumer
//      warpgroup (three), whose q and g tiles TMA brings in once. One producer warp
//      streams the key tiles (k, v; 64 rows) through a ring of mbarrier-
//      guarded stages, twice. First sweep: s = q k^T and dp = g v^T (wgmma,
//      both operands K-major in shared memory), p in registers, the row sums
//      of p dp: delta, written with lse2 as (lse2, delta) pairs into a
//      (B, H, S_pad) f32x2 scratch (rows S..S_pad get (+inf, 0), so that a
//      padded query row gives p = 0 without a predicate). Second sweep: s and
//      dp again, ds in registers, dq += ds k (wgmma with ds repacked as the
//      register A operand and k read MN-major through the transpose bit).
//   2. flash_attn_bwd_dkdv_kernel: a block owns 128 keys, 64 per warpgroup
//      (two; k, v in once), and streams the query tiles (q, g and their (lse2,
//      delta) pairs). Per tile a warpgroup forms s^T = k q^T and dp^T = v g^T,
//      p^T and ds^T in registers, and accumulates dv += p^T g and dk += ds^T q
//      (register A, g / q read MN-major).
//
// Nine tile products for the formula's five: s and dp are formed in both
// sweeps of the dq pass and again in the dk/dv pass. Bound at the training
// shapes (b64, S = T = 485): vision h12 d64 needs 10*B*H*S*T*D = 116 GFLOP
// against 7 tensors of 47.7 MB (q, k, v, g in; dq, dk, dv out) and the lse,
// above the H100's bf16 ridge of ~295 FLOP/byte: bound by the tensor cores
// (117 us at 989 TFLOP/s). The S x T intermediates never reach HBM.
//
// q, k, v and g are read in place in their (B, S, H, D) layout through TMA
// tensor maps over their strides (g is often a strided view); rows past S or
// T come back as zeros. D is 16, 32, 64 or 96: a tile row is 32, 64 or 128
// bytes, the swizzle of its tensor map and descriptors, or at D = 96 three
// column chunks of 32 with the 64-byte swizzle (a 192-byte row has none;
// attn_hopper.cuh, `Cols`): three TMA boxes a tile, the k-steps of the score
// products walking the chunks, and dq, dk, dv as three n32 products a k-step
// into their 48-value accumulators. The dq pass takes two consumer
// warpgroups there (128 query rows a block): three would leave a thread 152
// registers, too few for the wider accumulator.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see tunevlseg_torch/ops/build.py). Plain C entry point,
// loaded with ctypes; the tensor maps are encoded on the host in it.

#include "attn_hopper.cuh"

namespace {

using namespace tvs;

constexpr int kRows = 64;                  // rows of a warpgroup's tile and of a streamed tile
constexpr int kBlockRows = 2 * kRows;      // keys a dk/dv block owns: two consumer warpgroups
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kStages = 2;
constexpr int kStatBytes = kRows * 8;      // (lse2, delta) of a streamed tile's 64 rows
// The dq pass takes three consumer warpgroups (152 registers a thread, 1
// block per SM): more warps to hide its latencies than two, 1-9% faster on
// the card (PERF.md); the dk/dv pass's 168 registers allow two. At D = 96
// the dq pass takes two (its accumulator is half as large again).
template <int D>
struct Dq {
  static constexpr int kWgs = D == 96 ? 2 : 3;
  static constexpr int kRowsPerBlock = kWgs * kRows;  // query rows a dq block owns
  static constexpr int kConsumers = kWgs * 128;
  static constexpr int kThreads = kConsumers + 32;
};

// (batch, sequence, head) strides of one tensor, in elements; unit stride on D.
struct Strides {
  long long v[3];
};

// Shared memory of both passes: the owned tiles (two tensors x WGS
// warpgroups), the ring (two tensors per stage, and in the dk/dv pass the
// rows' statistics), the barriers.
template <int D, int WGS = 2>
struct Smem {
  static constexpr int kSwizzle = Cols<D>::kSwizzle;
  static constexpr int kTile = kRows * D * 2;            // bytes of a 64-row tile
  static constexpr int kPitch = kRows * Cols<D>::kW * 2;  // a column chunk of it
  static constexpr int kOwned = 2 * WGS * kTile;
  static constexpr int kRing = kStages * 2 * kTile;
  static constexpr int kStats = kStages * kStatBytes;
  static constexpr int kBars = kOwned + kRing + kStats;
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8 + 1024;  // + alignment slack
};

// The dk/dv pass: dk and dv of 128 keys.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_g,
                           const __grid_constant__ CUtensorMap tm_stats,
                           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S,
                           int T, int t_valid, float scale, float scale_log2, Strides dks,
                           Strides dvs) {
  using L = Smem<D>;
  const int n0 = blockIdx.x * kBlockRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  if (n0 >= t_valid) {
    // only masked keys: zero rows, nothing computed (block-uniform test)
    constexpr int kPieces = D / 8;
    for (int i = threadIdx.x; i < kBlockRows * kPieces; i += kThreads) {
      const int key = n0 + i / kPieces;
      const int c = (i % kPieces) * 8;
      if (key >= T) continue;
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(dk + b * dks.v[0] + key * dks.v[1] + h * dks.v[2] + c) = z;
      *reinterpret_cast<uint4*>(dv + b * dvs.v[0] + key * dvs.v[1] + h * dvs.v[2] + c) = z;
    }
    return;
  }

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = smem;                       // 2 x 64 rows
  uint8_t* sV = smem + 2 * L::kTile;        // 2 x 64 rows
  uint8_t* sQ = smem + L::kOwned;           // stage s at s * 2 * kTile
  uint8_t* sG = sQ + L::kTile;
  uint8_t* sStat = smem + L::kOwned + L::kRing;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int n_tiles = (S + kRows - 1) / kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp == kConsumers / 32) {
    if (lane == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_g);
      tma_prefetch_map(&tm_stats);
      mbar_arrive_expect_tx(kv_full, 4 * L::kTile);
      for (int half = 0; half < 2; ++half) {
        tma_load_rows<D>(sK + half * L::kTile, L::kPitch, &tm_k, kv_full, h, n0 + half * kRows, b);
        tma_load_rows<D>(sV + half * L::kTile, L::kPitch, &tm_v, kv_full, h, n0 + half * kRows, b);
      }
      for (int m = 0; m < n_tiles; ++m) {
        const int s = m % kStages;
        mbar_wait(&empty[s], ((m / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * L::kTile + kStatBytes);
        tma_load_rows<D>(sQ + s * 2 * L::kTile, L::kPitch, &tm_q, &full[s], h, m * kRows, b);
        tma_load_rows<D>(sG + s * 2 * L::kTile, L::kPitch, &tm_g, &full[s], h, m * kRows, b);
        tma_load_3d(sStat + s * kStatBytes, &tm_stats, &full[s], 2 * m * kRows, h, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns keys n0 + 64 wg + [0, 64)
  const int wg = warp / 4;
  const AccPlace at = acc_place();
  const int key0 = n0 + wg * kRows + at.row;
  const bool live[2] = {key0 < t_valid, key0 + 8 < t_valid};
  float dk_acc[D / 2], dv_acc[D / 2];
  zero(dk_acc);
  zero(dv_acc);
  mbar_wait(kv_full, 0);
  const uint64_t desc_k = kmajor_desc(sK + wg * L::kTile, L::kSwizzle);
  const uint64_t desc_v = kmajor_desc(sV + wg * L::kTile, L::kSwizzle);

  for (int m = 0; m < n_tiles; ++m) {
    const int s = m % kStages;
    uint8_t* q_tile = sQ + s * 2 * L::kTile;
    uint8_t* g_tile = sG + s * 2 * L::kTile;
    mbar_wait(&full[s], (m / kStages) & 1);

    // st[key][query] = k q^T, dpt[key][query] = v g^T
    float st[32], dpt[32];
    zero(st);
    zero(dpt);
    fence_operands(st);
    fence_operands(dpt);
    wgmma_fence();
    const uint64_t desc_q = kmajor_desc(q_tile, L::kSwizzle);
    const uint64_t desc_g = kmajor_desc(g_tile, L::kSwizzle);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16(st, kstep_desc<D>(desc_k, L::kPitch, kk),
                      kstep_desc<D>(desc_q, L::kPitch, kk));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16(dpt, kstep_desc<D>(desc_v, L::kPitch, kk),
                      kstep_desc<D>(desc_g, L::kPitch, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(st);
    fence_operands(dpt);

    // p^T and ds^T in place; the columns are the tile's queries, whose
    // (lse2, delta) pairs came with the tile
    const float* stat = reinterpret_cast<const float*>(sStat + s * kStatBytes);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 pair = *reinterpret_cast<const float4*>(stat + 2 * (8 * j + at.col));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        const float l2 = (e & 1) ? pair.z : pair.x;
        const float delta = (e & 1) ? pair.w : pair.y;
        const float p = live[acc_row_half(i)] ? exp2f(st[i] * scale_log2 - l2) : 0.f;
        st[i] = p;
        dpt[i] = p * (dpt[i] - delta) * scale;
      }
    }
    uint32_t pa[4][4], dsa[4][4];
    acc_to_a<64>(st, pa);
    acc_to_a<64>(dpt, dsa);

    // dv += p^T g, dk += ds^T q: g and q as [query][D], MN-major
    fence_operands(dk_acc);
    fence_operands(dv_acc);
    wgmma_fence();
    const uint64_t mn_g = mnmajor_desc(g_tile, L::kSwizzle);
    const uint64_t mn_q = mnmajor_desc(q_tile, L::kSwizzle);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs_cols<D>(dv_acc, pa[kk], mn_g, L::kPitch, kk);
      wgmma_rs_cols<D>(dk_acc, dsa[kk], mn_q, L::kPitch, kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dk_acc);
    fence_operands(dv_acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_operands(pa[kk]);
      fence_operands(dsa[kk]);
    }
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
  }

  const float one[2] = {1.f, 1.f};
  const int first = n0 + wg * kRows;
  store_acc_rows<D>(dk + b * dks.v[0] + h * dks.v[2], dks.v[1], dk_acc, one, first, T, at);
  store_acc_rows<D>(dv + b * dvs.v[0] + h * dvs.v[2], dvs.v[1], dv_acc, one, first, T, at);
}

// The dq pass: delta, then dq, of kDqRows query rows.
template <int D>
__global__ void __launch_bounds__(Dq<D>::kThreads, 1)
flash_attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_g, const float* __restrict__ lse,
                         float2* __restrict__ stats, __nv_bfloat16* __restrict__ dq, int S,
                         int S_pad, int t_valid, float scale, float scale_log2, Strides dqs) {
  constexpr int kDqWgs = Dq<D>::kWgs;
  constexpr int kDqRows = Dq<D>::kRowsPerBlock;
  constexpr int kDqConsumers = Dq<D>::kConsumers;
  using L = Smem<D, kDqWgs>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem;                       // kDqWgs x 64 rows
  uint8_t* sG = smem + kDqWgs * L::kTile;   // kDqWgs x 64 rows
  uint8_t* sK = smem + L::kOwned;           // stage s at s * 2 * kTile
  uint8_t* sV = sK + L::kTile;
  uint64_t* qg_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = qg_full + 1;
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    mbar_init(qg_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kDqConsumers / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int m0 = blockIdx.x * kDqRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (t_valid + kRows - 1) / kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp == kDqConsumers / 32) {
    if (lane == 0) {
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      mbar_arrive_expect_tx(qg_full, 2 * kDqWgs * L::kTile);
      for (int half = 0; half < kDqWgs; ++half) {
        tma_load_rows<D>(sQ + half * L::kTile, L::kPitch, &tm_q, qg_full, h, m0 + half * kRows, b);
        tma_load_rows<D>(sG + half * L::kTile, L::kPitch, &tm_g, qg_full, h, m0 + half * kRows, b);
      }
      // the key tiles twice: once for delta, once for dq
      for (int it = 0; it < 2 * n_tiles; ++it) {
        const int s = it % kStages;
        const int n = it % n_tiles;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * L::kTile);
        tma_load_rows<D>(sK + s * 2 * L::kTile, L::kPitch, &tm_k, &full[s], h, n * kRows, b);
        tma_load_rows<D>(sV + s * 2 * L::kTile, L::kPitch, &tm_v, &full[s], h, n * kRows, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows m0 + 64 wg + [0, 64); rows past S
  // get lse2 = +inf, so p = 0 there
  const int wg = warp / 4;
  const AccPlace at = acc_place();
  const int first = m0 + wg * kRows;
  const int64_t bh = static_cast<int64_t>(b) * gridDim.y + h;
  float l2[2], delta[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = first + at.row + 8 * r;
    l2[r] = row < S ? lse[bh * S + row] : INFINITY;
  }
  float acc[D / 2];
  zero(acc);
  mbar_wait(qg_full, 0);
  const uint64_t desc_q = kmajor_desc(sQ + wg * L::kTile, L::kSwizzle);
  const uint64_t desc_g = kmajor_desc(sG + wg * L::kTile, L::kSwizzle);

  for (int it = 0; it < 2 * n_tiles; ++it) {
    const int s = it % kStages;
    const int n = it % n_tiles;
    const bool sweep_dq = it >= n_tiles;
    uint8_t* k_tile = sK + s * 2 * L::kTile;
    uint8_t* v_tile = sV + s * 2 * L::kTile;
    mbar_wait(&full[s], (it / kStages) & 1);

    // sc[query][key] = q k^T, dp[query][key] = g v^T
    float sc[32], dp[32];
    zero(sc);
    zero(dp);
    fence_operands(sc);
    fence_operands(dp);
    wgmma_fence();
    const uint64_t desc_k = kmajor_desc(k_tile, L::kSwizzle);
    const uint64_t desc_v = kmajor_desc(v_tile, L::kSwizzle);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16(sc, kstep_desc<D>(desc_q, L::kPitch, kk),
                      kstep_desc<D>(desc_k, L::kPitch, kk));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16(dp, kstep_desc<D>(desc_g, L::kPitch, kk),
                      kstep_desc<D>(desc_v, L::kPitch, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);
    fence_operands(dp);

    // keys at or past t_valid (only in the last tile) get p = 0
    const int key_end = t_valid - n * kRows;  // columns >= key_end are masked
    if (!sweep_dq) {
      // first sweep: this thread's share of delta = sum_j p dp
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = acc_row_half(i);
        const float p = acc_col(i, at.col) < key_end ? exp2f(sc[i] * scale_log2 - l2[r]) : 0.f;
        delta[r] += p * dp[i];
      }
      if (lane == 0) mbar_arrive(&empty[s]);
      if (n == n_tiles - 1) {
        // the rows' delta, and (lse2, delta) for the dk/dv pass
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          delta[r] = group4_sum(delta[r]);
          const int row = first + at.row + 8 * r;
          if (at.col == 0)
            stats[bh * S_pad + row] = row < S ? make_float2(l2[r], delta[r])
                                              : make_float2(INFINITY, 0.f);
        }
      }
      continue;
    }

    // second sweep: ds in place of dp, dq += ds k (k as [key][D], MN-major)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = acc_row_half(i);
      const float p = acc_col(i, at.col) < key_end ? exp2f(sc[i] * scale_log2 - l2[r]) : 0.f;
      dp[i] = p * (dp[i] - delta[r]) * scale;
    }
    uint32_t dsa[4][4];
    acc_to_a<64>(dp, dsa);
    fence_operands(acc);
    wgmma_fence();
    const uint64_t mn_k = mnmajor_desc(k_tile, L::kSwizzle);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_cols<D>(acc, dsa[kk], mn_k, L::kPitch, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_operands(dsa[kk]);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const float one[2] = {1.f, 1.f};
  store_acc_rows<D>(dq + b * dqs.v[0] + h * dqs.v[2], dqs.v[1], acc, one, first, S, at);
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g, const float* lse,
                   void* dq, void* dk, void* dv, float2* stats, int B, int S, int S_pad, int T,
                   int H, int t_valid, const long long* st, cudaStream_t stream) {
  using L = Smem<D>;
  if (S_pad % Dq<D>::kRowsPerBlock != 0) return cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const float scale_log2 = scale * 1.4426950408889634f;
  Strides ss[7];  // q, k, v, g, dq, dk, dv
  for (int t = 0; t < 7; ++t)
    for (int i = 0; i < 3; ++i) ss[t].v[i] = st[3 * t + i];

  cudaError_t err = make_context_current();
  if (err != cudaSuccess) return err;
  CUtensorMap tm_q, tm_k, tm_v, tm_g, tm_stats;
  if (!encode_bshd(&tm_q, q, B, S, H, D, ss[0].v, kRows) ||
      !encode_bshd(&tm_k, k, B, T, H, D, ss[1].v, kRows) ||
      !encode_bshd(&tm_v, v, B, T, H, D, ss[2].v, kRows) ||
      !encode_bshd(&tm_g, g, B, S, H, D, ss[3].v, kRows) ||
      !encode_f32_3d(&tm_stats, stats, 2 * uint64_t(S_pad), H, B, 2 * kRows))
    return cudaErrorNotSupported;

  using Lq = Smem<D, Dq<D>::kWgs>;
  if ((err = set_smem(flash_attn_bwd_dq_kernel<D>, Lq::kBytes)) != cudaSuccess) return err;
  const dim3 grid_q((S + Dq<D>::kRowsPerBlock - 1) / Dq<D>::kRowsPerBlock, H, B);
  flash_attn_bwd_dq_kernel<D><<<grid_q, Dq<D>::kThreads, Lq::kBytes, stream>>>(
      tm_q, tm_k, tm_v, tm_g, lse, stats, static_cast<__nv_bfloat16*>(dq), S, S_pad, t_valid,
      scale, scale_log2, ss[4]);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = set_smem(flash_attn_bwd_dkdv_kernel<D>, L::kBytes)) != cudaSuccess) return err;
  const dim3 grid_k((T + kBlockRows - 1) / kBlockRows, H, B);
  flash_attn_bwd_dkdv_kernel<D><<<grid_k, kThreads, L::kBytes, stream>>>(
      tm_q, tm_k, tm_v, tm_g, tm_stats, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), S, T, t_valid, scale, scale_log2, ss[5], ss[6]);
  return cudaGetLastError();
}

}  // namespace

// q, g, dq (B, S, H, D) and k, v, dk, dv (B, T, H, D), all bf16 with unit
// stride on D, 16-byte aligned bases and strides that are multiples of 8
// elements (TMA reads them in place); lse (B, H, S) f32 from K1; stats f32
// scratch of B * H * S_pad * 2 elements, S_pad >= S a multiple of both
// passes' block rows at every head dim, 384 (STATS_ROWS in
// ops/flash_attention.py).
// `strides` holds the (batch, seq, head) strides in elements of q, k, v, g,
// dq, dk and dv, in that order (21 values). Keys at index >= t_valid are
// masked (t_valid = kv_valid, or T). The two kernels are enqueued on
// `stream`; returns the cudaError_t of the first failed launch
// (cudaErrorNotSupported if a tensor map could not be encoded).
extern "C" int tvs_flash_attn_bwd(const void* q, const void* k, const void* v, const void* g,
                                  const void* lse, void* dq, void* dk, void* dv, void* stats,
                                  int B, int S, int S_pad, int T, int H, int D, int t_valid,
                                  const long long* strides, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || H <= 0 || B > 65535 || H > 65535 || t_valid < 1 ||
      t_valid > T || S_pad < S || S_pad % kRows != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(lse);
  float2* sp = static_cast<float2*>(stats);
  switch (D) {
    case 16:
      return static_cast<int>(
          launch<16>(q, k, v, g, lp, dq, dk, dv, sp, B, S, S_pad, T, H, t_valid, strides, st));
    case 32:
      return static_cast<int>(
          launch<32>(q, k, v, g, lp, dq, dk, dv, sp, B, S, S_pad, T, H, t_valid, strides, st));
    case 64:
      return static_cast<int>(
          launch<64>(q, k, v, g, lp, dq, dk, dv, sp, B, S, S_pad, T, H, t_valid, strides, st));
    case 96:
      return static_cast<int>(
          launch<96>(q, k, v, g, lp, dq, dk, dv, sp, B, S, S_pad, T, H, t_valid, strides, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
