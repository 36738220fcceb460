// S1-S4: the variants of K1 (the unbiased self-attention forward) that the
// attention sweeps time, for Hopper (sm_90a), bf16 in / bf16 out.
//
// They replace the Pallas TPU kernels of the JAX package's sweep scripts:
//   S1  scripts/micro_attn.py: make_hg             hg heads per grid cell
//   S2  scripts/micro_attn_v2.py: batched_heads    exp2 / no max pass / the two
//                                                  products without a softmax /
//                                                  forced hg / grid semantics
//   S3  scripts/micro_attn_v2.py: batched_heads_opt  scale folded into q, the
//                                                  mask as an additive row, exp2,
//                                                  the denominator out of the
//                                                  P V product
//   S4  scripts/micro_attn_grid.py: make           bg batch rows x hg heads per
//                                                  grid cell, grid semantics
// None of them is on a model's path: the models run K1 (flash_attn_fwd.cu).
// They are the tool for redesigning it, K1 with its choices as switches.
//
// What the switches mean on this card. The TPU kernels hold a head's whole
// S x T f32 score tile in VMEM and walk a sequential grid; here S1, S2 and S4
// keep K1's structure (one block of 4 warps per 64 query rows, keys streamed
// through shared memory in tiles of 64, online softmax, mma.sync m16n8k16).
//   * "hg heads / bg batch rows per grid cell" is a block that owns one query
//     tile and loops over its bg x hg (batch, head) pairs: fewer, longer
//     blocks. hg and bg are launch parameters, the loop is the same code.
//   * `dimension_semantics` has no meaning in CUDA. Its counterpart is the
//     order in which blockIdx maps to (batch group, head group, query tile):
//     query-tile-fastest, so that neighbouring blocks share one head's K and V
//     in L2, or head-fastest. A launch parameter.
//   * USE_EXP2: p = exp2(s * scale * log2(e) - m) against expf(s * scale - m).
//   * SKIP_MAX: no running maximum and no rescale of the accumulator,
//     p = exp(s). An experiment, as in the script: it overflows for scores
//     above ~88 (~128 with exp2).
//   * GEMM_ONLY: o = (q k^T * scale) v over all T keys, no softmax, no mask.
// S3 (attn_ones_column_kernel) is built the Hopper way, on the attention
// building blocks of attn_hopper.cuh, which K2 shares: one producer warp
// feeding two consumer warpgroups through a TMA / mbarrier ring, 128 query
// rows a block, wgmma for both products with p kept in registers. Its recipe:
// q is multiplied by the bf16 factor D^-1/2 * log2(e) (in the kernel, on the
// Q tile in shared memory); an f32 mask row (0 on valid keys, -1e30 beyond;
// padded to whole key tiles of 64) is added to the scores in the place of the
// compare-and-select; the denominator comes out of the P V step, as an n8
// product of the same bf16 p against a constant [1, 0, ..., 0] tile, rescaled
// with the output like any of its columns; the epilogue multiplies by its
// reciprocal. The sum is of the bf16-ROUNDED p, accumulated in f32: it
// differs from K1's f32 sum of the unrounded p by at most about 2^-9 relative.
//
// Bound: as K1. At b64 S = T = 485 h12 d64 the call does 46 GFLOP against
// 191 MB of q, k, v and o: bound by bytes, by a small margin over the tensor
// cores. What limits S1, S2 and S4 in fact is neither: mma.sync's rate and
// the softmax's f32 work between the two products.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC into a library of its own (tunevlseg_torch/ops/build.py),
// so that a process that never sweeps never builds it. Plain C entry points,
// loaded with ctypes (tunevlseg_torch/ops/flash_attention_variants.py).

#include "attn_hopper.cuh"

namespace {

using namespace tvs;

constexpr int kBlockM = 64;  // query rows per block, 16 per warp
constexpr int kBlockN = 64;  // keys per shared-memory tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kScoreTiles = kBlockN / 8;
constexpr int kKeySteps = kBlockN / 16;

// (batch, seq, head) strides in elements of q, k, v and o
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

// How the grid is cut: hg heads and bg batch rows per block, and the order
// of the blocks.
struct Blocking {
  int hg, bg, n_qt, n_hg, head_fastest;
};

struct Cell {
  int qt, hgi, bgi;
};

__device__ __forceinline__ Cell block_cell(const Blocking& bl) {
  int idx = blockIdx.x;
  Cell c;
  if (bl.head_fastest) {
    c.hgi = idx % bl.n_hg;
    idx /= bl.n_hg;
    c.qt = idx % bl.n_qt;
    c.bgi = idx / bl.n_qt;
  } else {
    c.qt = idx % bl.n_qt;
    idx /= bl.n_qt;
    c.hgi = idx % bl.n_hg;
    c.bgi = idx / bl.n_hg;
  }
  return c;
}

// A fragments of a warp's 16 query rows (first row r0 = warp * 16 + g).
template <int D>
__device__ __forceinline__ void read_q_frags(uint32_t (&qa)[D / 16][4], const __nv_bfloat16* sQ,
                                             int r0, int tig) {
  constexpr int kStride = D + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* base = sQ + r0 * kStride + kk * 16 + tig * 2;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(base);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kStride);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(base + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kStride + 8);
  }
}

// s = q k^T of the warp's 16 rows against the 64 keys of the shared tile.
template <int D>
__device__ __forceinline__ void qk_scores(float (&s)[kScoreTiles][4],
                                          const uint32_t (&qa)[D / 16][4],
                                          const __nv_bfloat16* sK, int g, int tig) {
  constexpr int kStride = D + 8;
#pragma unroll
  for (int nt = 0; nt < kScoreTiles; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* kb = sK + (nt * 8 + g) * kStride + kk * 16 + tig * 2;
      mma_bf16_16816(s[nt], qa[kk], *reinterpret_cast<const uint32_t*>(kb),
                     *reinterpret_cast<const uint32_t*>(kb + 8));
    }
  }
}

// acc += p v over the 64 keys of the shared tile, for kTiles groups of 8
// output columns. kStride is the row stride of sV.
template <int kTiles, int kStride>
__device__ __forceinline__ void pv_accumulate(float (&acc)[kTiles][4],
                                              const uint32_t (&pa)[kKeySteps][4],
                                              const unsigned short* sV, int g, int tig) {
#pragma unroll
  for (int kk = 0; kk < kKeySteps; ++kk) {
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt) {
      // B[key][dim] = V[key][dim]: two keys per register, one dim column
      const unsigned short* vb = sV + (kk * 16 + tig * 2) * kStride + nt * 8 + g;
      const uint32_t b0 = pack_raw(vb[0], vb[kStride]);
      const uint32_t b1 = pack_raw(vb[8 * kStride], vb[9 * kStride]);
      mma_bf16_16816(acc[nt], pa[kk], b0, b1);
    }
  }
}

// S1, S2, S4. `scale` is D^-1/2, times log2(e) with USE_EXP2.
template <int D, bool USE_EXP2, bool SKIP_MAX, bool GEMM_ONLY>
__global__ void __launch_bounds__(kThreads)
attn_variant_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int S,
                    int T, int t_valid, float scale, Strides st, Blocking bl) {
  constexpr int kStride = D + 8;
  constexpr int kOutTiles = D / 8;

  __shared__ __align__(16) __nv_bfloat16 sQ[kBlockM * kStride];
  __shared__ __align__(16) __nv_bfloat16 sK[kBlockN * kStride];
  __shared__ __align__(16) __nv_bfloat16 sV[kBlockN * kStride];

  const Cell cell = block_cell(bl);
  const int m0 = cell.qt * kBlockM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tig = lane % 4;
  const int r0 = warp * 16 + g;
  const int t_end = GEMM_ONLY ? T : t_valid;
  const unsigned short* sVraw = reinterpret_cast<const unsigned short*>(sV);

  for (int pair = 0; pair < bl.bg * bl.hg; ++pair) {
    const int b = cell.bgi * bl.bg + pair / bl.hg;
    const int h = cell.hgi * bl.hg + pair % bl.hg;

    // No barrier in front of this store: a warp gets here only after every
    // warp passed the key loop's first barrier of the previous pair, and so
    // has read its q fragments; the key loop does not read sQ.
    load_tile<D, kBlockM, kThreads>(sQ, q + b * st.q[0] + h * st.q[2] + m0 * st.q[1], st.q[1],
                                    S - m0);
    __syncthreads();
    uint32_t qa[D / 16][4];
    read_q_frags<D>(qa, sQ, r0, tig);

    float acc[kOutTiles][4];
#pragma unroll
    for (int nt = 0; nt < kOutTiles; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    float row_max[2] = {-INFINITY, -INFINITY};
    float row_sum[2] = {0.f, 0.f};

    const __nv_bfloat16* kbase = k + b * st.k[0] + h * st.k[2];
    const __nv_bfloat16* vbase = v + b * st.v[0] + h * st.v[2];

    for (int n0 = 0; n0 < t_end; n0 += kBlockN) {
      __syncthreads();  // every warp is done with the previous K/V tile
      load_tile<D, kBlockN, kThreads>(sK, kbase + n0 * st.k[1], st.k[1], t_end - n0);
      load_tile<D, kBlockN, kThreads>(sV, vbase + n0 * st.v[1], st.v[1], t_end - n0);
      __syncthreads();

      float s[kScoreTiles][4];
      qk_scores<D>(s, qa, sK, g, tig);

      uint32_t pa[kKeySteps][4];
      if constexpr (GEMM_ONLY) {
        // zero-filled key rows give s = 0: nothing to mask
#pragma unroll
        for (int nt = 0; nt < kScoreTiles; ++nt) {
          pa[nt / 2][(nt % 2) * 2 + 0] = pack_f32x2(s[nt][0] * scale, s[nt][1] * scale);
          pa[nt / 2][(nt % 2) * 2 + 1] = pack_f32x2(s[nt][2] * scale, s[nt][3] * scale);
        }
      } else {
        float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int nt = 0; nt < kScoreTiles; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = n0 + nt * 8 + tig * 2 + (i & 1);
            const float x = col < t_valid ? s[nt][i] * scale : -INFINITY;
            s[nt][i] = x;
            if constexpr (!SKIP_MAX) tile_max[i >> 1] = fmaxf(tile_max[i >> 1], x);
          }
        }
        float shift[2] = {0.f, 0.f};
        if constexpr (!SKIP_MAX) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            // key 0 is always valid, so the running max is finite after tile 0
            const float new_max = fmaxf(row_max[r], group4_max(tile_max[r]));
            const float corr =
                USE_EXP2 ? exp2f(row_max[r] - new_max) : expf(row_max[r] - new_max);
            row_max[r] = new_max;
            row_sum[r] *= corr;
            shift[r] = new_max;
#pragma unroll
            for (int nt = 0; nt < kOutTiles; ++nt) {
              acc[nt][2 * r] *= corr;
              acc[nt][2 * r + 1] *= corr;
            }
          }
        }
#pragma unroll
        for (int nt = 0; nt < kScoreTiles; ++nt) {
          float p[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float x = s[nt][i] - shift[i >> 1];
            p[i] = USE_EXP2 ? exp2f(x) : expf(x);
          }
          row_sum[0] += p[0] + p[1];
          row_sum[1] += p[2] + p[3];
          pa[nt / 2][(nt % 2) * 2 + 0] = pack_f32x2(p[0], p[1]);
          pa[nt / 2][(nt % 2) * 2 + 1] = pack_f32x2(p[2], p[3]);
        }
      }
      pv_accumulate<kOutTiles, kStride>(acc, pa, sVraw, g, tig);
    }

    const float inv0 = GEMM_ONLY ? 1.f : 1.f / group4_sum(row_sum[0]);
    const float inv1 = GEMM_ONLY ? 1.f : 1.f / group4_sum(row_sum[1]);
    const int row_a = m0 + r0;
    const int row_b = row_a + 8;
    __nv_bfloat16* obase = o + b * st.o[0] + h * st.o[2];
#pragma unroll
    for (int nt = 0; nt < kOutTiles; ++nt) {
      const int col = nt * 8 + tig * 2;
      if (row_a < S)
        *reinterpret_cast<uint32_t*>(obase + row_a * st.o[1] + col) =
            pack_f32x2(acc[nt][0] * inv0, acc[nt][1] * inv0);
      if (row_b < S)
        *reinterpret_cast<uint32_t*>(obase + row_b * st.o[1] + col) =
            pack_f32x2(acc[nt][2] * inv1, acc[nt][3] * inv1);
    }
  }
}

// S3 on Hopper's own path: warpgroup products from a TMA ring.
namespace s3 {
constexpr int kD = 64;
constexpr int kBM = 128;                   // query rows per block, 64 per consumer warpgroup
constexpr int kBN = 64;                    // keys per ring stage
constexpr int kStages = 3;
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kTileBytes = kBN * kD * 2;   // a K or V tile, 8 KB
constexpr int kQBytes = kBM * kD * 2;      // 16 KB
constexpr int kOutStride = kD + 8;         // bf16 staging rows, padded against bank conflicts
constexpr int kQOff = 0;
constexpr int kKOff = kQOff + kQBytes;
constexpr int kVOff = kKOff + kStages * kTileBytes;
constexpr int kOnesOff = kVOff + kStages * kTileBytes;  // 8 x 64 bf16: [1 ... 1], then zeros
constexpr int kOutOff = kOnesOff + 1024;
constexpr int kBarOff = kOutOff + 2 * 64 * kOutStride * 2;
constexpr int kBytes = kBarOff + (2 * kStages + 2) * 8 + 1024;  // + alignment slack
}  // namespace s3

// S3. The scale D^-1/2 * log2(e), rounded to bf16 (`qscale`), is folded into
// the Q tile in shared memory; `mask` is an f32 row of ceil(T / 64) * 64
// entries added to the scores, or null when no key is masked and T is a
// multiple of 64.
//
// A block is one producer warp and two consumer warpgroups and owns 128 query
// rows (64 per warpgroup) of each of its (batch, head) pairs. The producer
// brings the pair's Q tile by TMA once (after both warpgroups released the
// last one) and streams K and V tiles of 64 keys through a ring of kStages
// stages (full / empty mbarriers); rows past S or T arrive as zeros. A
// warpgroup multiplies its 64 rows of Q by the bf16 factor in place, then per
// key tile: s = q k^T (wgmma, both K-major), the mask row added, the online
// exp2 softmax in registers, p repacked as the register A operand of
// o += p v (V read MN-major through the transpose bit) and of an n8 product
// against a constant [1, 0, ..., 0] tile that leaves the f32 sum of the bf16
// p in column 0: the denominator, rescaled with o. The epilogue multiplies by
// its reciprocal, stages the rows in shared memory and stores 16 bytes a
// thread.
// Two blocks per SM (96 registers a thread, a few bytes spilled): 10% faster
// on the card than one block of 120 registers (PERF.md).
template <bool SKIP_MAX>
__global__ void __launch_bounds__(s3::kThreads, 2)
attn_ones_column_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ mask,
                        __nv_bfloat16* __restrict__ o, int S, int T, float qscale, Strides st,
                        Blocking bl) {
  using namespace s3;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;
  uint64_t* q_empty = q_full + 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);  // one arrival per consumer warp
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumers / 32);
    fence_barrier_init();
  }
  // the B operand of the row sums, K-major: row 0 (one 128-byte row of 64
  // keys) all ones, rows 1-7 zeros; a swizzle only moves whole 16-byte
  // pieces within a row, so the tile reads the same under it
  for (int i = threadIdx.x; i < 64; i += blockDim.x)
    reinterpret_cast<uint4*>(smem + kOnesOff)[i] =
        i < 8 ? make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u)
              : make_uint4(0u, 0u, 0u, 0u);
  fence_view_async_shared();
  __syncthreads();

  const Cell cell = block_cell(bl);
  const int pairs = bl.bg * bl.hg;
  const int n_tiles = (T + kBN - 1) / kBN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp == kConsumers / 32) {
    if (lane == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      int it = 0;
      for (int pair = 0; pair < pairs; ++pair) {
        const int b = cell.bgi * bl.bg + pair / bl.hg;
        const int h = cell.hgi * bl.hg + pair % bl.hg;
        mbar_wait(q_empty, (pair & 1) ^ 1);
        mbar_arrive_expect_tx(q_full, kQBytes);
        tma_load_4d(smem + kQOff, &tm_q, q_full, 0, h, cell.qt * kBM, b);
        for (int n = 0; n < n_tiles; ++n, ++it) {
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], 2 * kTileBytes);
          tma_load_4d(smem + kKOff + s * kTileBytes, &tm_k, &full[s], 0, h, n * kBN, b);
          tma_load_4d(smem + kVOff + s * kTileBytes, &tm_v, &full[s], 0, h, n * kBN, b);
        }
      }
    }
    return;
  }

  const int wg = warp / 4;
  const int t = threadIdx.x % 128;
  const AccPlace at = acc_place();
  uint8_t* sQ = smem + kQOff + wg * 64 * kD * 2;  // this warpgroup's 64 rows
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem + kOutOff) + wg * 64 * kOutStride;
  const uint64_t desc_q = kmajor_desc(sQ, 128);
  const uint64_t desc_ones = kmajor_desc(smem + kOnesOff, 128);
  int it = 0;
  for (int pair = 0; pair < pairs; ++pair) {
    const int b = cell.bgi * bl.bg + pair / bl.hg;
    const int h = cell.hgi * bl.hg + pair % bl.hg;
    mbar_wait(q_full, pair & 1);
    // q * factor in bf16, as fold_scale rounds it: the product of two bf16
    // values is exact in f32, so one rounding
    for (int i = t; i < 64 * kD / 8; i += 128) {
      uint4* piece = reinterpret_cast<uint4*>(sQ) + i;
      float f[8];
      unpack8(*piece, f);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] *= qscale;
      *piece = pack8(f);
    }
    fence_view_async_shared();
    named_barrier(1 + wg, 128);

    float acc[kD / 2], sum[4];
    zero(acc);
    zero(sum);
    float row_max[2] = {-INFINITY, -INFINITY};
    for (int n = 0; n < n_tiles; ++n, ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      float sc[32];
      zero(sc);
      fence_operands(sc);
      wgmma_fence();
      const uint64_t desc_k = kmajor_desc(smem + kKOff + s * kTileBytes, 128);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) wgmma_m64n64k16(sc, desc_q + 2 * kk, desc_k + 2 * kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(sc);
      // the pair's last read of its Q tile: both warpgroups' warps release it
      if (n == n_tiles - 1 && lane == 0) mbar_arrive(q_empty);

      if (mask != nullptr) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 mk = __ldg(reinterpret_cast<const float2*>(mask + n * kBN + 8 * j + at.col));
          sc[4 * j + 0] += mk.x;
          sc[4 * j + 1] += mk.y;
          sc[4 * j + 2] += mk.x;
          sc[4 * j + 3] += mk.y;
        }
      }
      float shift[2] = {0.f, 0.f};
      if constexpr (!SKIP_MAX) {
        float tile_max[2];
        acc_row_max(sc, tile_max);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float new_max = fmaxf(row_max[r], tile_max[r]);
          const float corr = exp2f(row_max[r] - new_max);
          row_max[r] = new_max;
          shift[r] = new_max;
#pragma unroll
          for (int i = 0; i < kD / 2; ++i)
            if (acc_row_half(i) == r) acc[i] *= corr;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (acc_row_half(i) == r) sum[i] *= corr;
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = exp2f(sc[i] - shift[acc_row_half(i)]);
      uint32_t pa[4][4];
      acc_to_a<64>(sc, pa);

      fence_operands(acc);
      fence_operands(sum);
      wgmma_fence();
      const uint64_t mn_v = mnmajor_desc(smem + kVOff + s * kTileBytes, 128);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs<64, 1>(acc, pa[kk], mn_v + kk * ((16 * 128) >> 4));
        wgmma_rs<8, 0>(sum, pa[kk], desc_ones + 2 * kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
      fence_operands(sum);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_operands(pa[kk]);
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // column 0 of the sums sits in the first thread of each group of four
    const float inv[2] = {1.f / __shfl_sync(0xffffffffu, sum[0], lane & ~3),
                          1.f / __shfl_sync(0xffffffffu, sum[2], lane & ~3)};
    named_barrier(1 + wg, 128);  // the last pair's reads of the staging tile are done
    store_acc_rows<kD>(stage, kOutStride, acc, inv, 0, 64, at);
    named_barrier(1 + wg, 128);
    const int m0 = cell.qt * kBM + wg * 64;
    __nv_bfloat16* obase = o + b * st.o[0] + h * st.o[2];
    for (int i = t; i < 64 * kD / 8; i += 128) {
      const int r = i / (kD / 8);
      const int c = (i % (kD / 8)) * 8;
      if (m0 + r < S)
        *reinterpret_cast<uint4*>(obase + (m0 + r) * st.o[1] + c) =
            *reinterpret_cast<const uint4*>(stage + r * kOutStride + c);
    }
  }
}

Strides make_strides(const long long* s) {
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = s[i];
    st.k[i] = s[3 + i];
    st.v[i] = s[6 + i];
    st.o[i] = s[9 + i];
  }
  return st;
}

// The grid of a launch with `block_m` query rows a block, or false when hg /
// bg do not divide H / B.
bool make_blocking(int B, int S, int H, int hg, int bg, int head_fastest, int block_m,
                   Blocking* bl, unsigned* blocks) {
  if (hg < 1 || bg < 1 || H % hg || B % bg) return false;
  bl->hg = hg;
  bl->bg = bg;
  bl->n_qt = (S + block_m - 1) / block_m;
  bl->n_hg = H / hg;
  bl->head_fastest = head_fastest;
  *blocks = static_cast<unsigned>(bl->n_qt) * bl->n_hg * (B / bg);
  return true;
}

template <bool USE_EXP2, bool SKIP_MAX, bool GEMM_ONLY>
cudaError_t launch_variant(const void* q, const void* k, const void* v, void* o, int S, int T,
                           int t_valid, const Strides& st, const Blocking& bl, unsigned blocks,
                           cudaStream_t stream) {
  constexpr int D = 64;
  float scale = 1.0f / sqrtf(static_cast<float>(D));
  if (USE_EXP2) scale *= 1.4426950408889634f;
  attn_variant_kernel<D, USE_EXP2, SKIP_MAX, GEMM_ONLY><<<blocks, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, T, t_valid, scale,
      st, bl);
  return cudaGetLastError();
}

}  // namespace

// S1, S2, S4. q (B, S, H, 64), k and v (B, T, H, 64), o (B, S, H, 64), bf16
// with unit stride on the last dimension; `strides` as in tvs_flash_attn_fwd
// (12 values). `flags`: bit 0 USE_EXP2, bit 1 SKIP_MAX, bit 2 GEMM_ONLY
// (alone). hg heads and bg batch rows per block (they must divide H and B);
// head_fastest picks the block order. Returns the cudaError_t of the launch.
extern "C" int tvs_attn_variant(const void* q, const void* k, const void* v, void* o, int B, int S,
                                int T, int H, int D, int t_valid, int flags, int hg, int bg,
                                int head_fastest, const long long* strides, void* stream) {
  Blocking bl;
  unsigned blocks;
  if (D != 64 || !make_blocking(B, S, H, hg, bg, head_fastest, kBlockM, &bl, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st = make_strides(strides);
  const cudaStream_t sm = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (flags) {
    case 0: err = launch_variant<false, false, false>(q, k, v, o, S, T, t_valid, st, bl, blocks, sm); break;
    case 1: err = launch_variant<true, false, false>(q, k, v, o, S, T, t_valid, st, bl, blocks, sm); break;
    case 2: err = launch_variant<false, true, false>(q, k, v, o, S, T, t_valid, st, bl, blocks, sm); break;
    case 3: err = launch_variant<true, true, false>(q, k, v, o, S, T, t_valid, st, bl, blocks, sm); break;
    case 4: err = launch_variant<false, false, true>(q, k, v, o, S, T, t_valid, st, bl, blocks, sm); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// S3. As above (q, k and v read in place by TMA: 16-byte aligned, strides
// multiples of 8 elements), with `mask` an f32 row of ceil(T / 64) * 64
// entries (or null: nothing masked). The scale is folded into q inside the
// kernel. Returns the cudaError_t of the launch (cudaErrorNotSupported if a
// tensor map could not be encoded).
extern "C" int tvs_attn_ones_column(const void* q, const void* k, const void* v, const void* mask,
                                    void* o, int B, int S, int T, int H, int D, int skip_max,
                                    int hg, int bg, int head_fastest, const long long* strides,
                                    void* stream) {
  Blocking bl;
  unsigned blocks;
  if (D != 64 || !make_blocking(B, S, H, hg, bg, head_fastest, s3::kBM, &bl, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st = make_strides(strides);
  cudaError_t err = make_context_current();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode_bshd(&tm_q, q, B, S, H, 64, st.q, s3::kBM) ||
      !encode_bshd(&tm_k, k, B, T, H, 64, st.k, s3::kBN) ||
      !encode_bshd(&tm_v, v, B, T, H, 64, st.v, s3::kBN))
    return static_cast<int>(cudaErrorNotSupported);
  // D^-1/2 * log2(e) rounded to bf16, as fold_scale rounds it
  const float qscale = __bfloat162float(__float2bfloat16(static_cast<float>(0.125 * 1.4426950408889634)));
  const cudaStream_t sm = static_cast<cudaStream_t>(stream);
  const float* mp = static_cast<const float*>(mask);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(o);
  auto kernel = skip_max ? attn_ones_column_kernel<true> : attn_ones_column_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, s3::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, s3::kThreads, s3::kBytes, sm>>>(tm_q, tm_k, tm_v, mp, op, S, T, qscale, st, bl);
  return static_cast<int>(cudaGetLastError());
}
