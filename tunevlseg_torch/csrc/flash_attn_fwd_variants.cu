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
// S x T f32 score tile in VMEM and walk a sequential grid; here every variant
// keeps K1's structure (one block of 4 warps per 64 query rows, keys streamed
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
//   * S3 (attn_ones_column_kernel): q arrives multiplied by scale * log2(e);
//     an f32 mask row (0 on valid keys, -1e30 beyond; padded to whole key
//     tiles) is added to the scores in the place of the compare-and-select;
//     V's shared tile carries a column of ones after its D columns (in the
//     8-column pad that keeps the fragment reads free of bank conflicts), so
//     the P V mma leaves the row sum in accumulator column D and the online
//     rescale treats it like every other column. The epilogue multiplies by
//     its reciprocal. The sum is then of the bf16-ROUNDED p, accumulated in
//     f32: it differs from K1's f32 sum of the unrounded p by at most about
//     2^-9 relative.
//
// Bound: as K1. At b64 S = T = 485 h12 d64 the call does 46 GFLOP against
// 191 MB of q, k, v and o: bound by bytes, by a small margin over the tensor
// cores. What limits these kernels in fact is neither: mma.sync issue and the
// softmax's f32 work between the two products.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC into a library of its own (tunevlseg_torch/ops/build.py),
// so that a process that never sweeps never builds it. Plain C entry points,
// loaded with ctypes (tunevlseg_torch/ops/flash_attention_variants.py).

#include "attn_common.cuh"

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
// output columns (D / 8, or one more for the ones column of S3). kStride is
// the row stride of sV.
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

// S3. q is already multiplied by D^-1/2 * log2(e); `mask` is an f32 row of
// ceil(T / 64) * 64 entries added to the scores, or null when no key is
// masked and T is a multiple of 64.
template <int D, bool SKIP_MAX>
__global__ void __launch_bounds__(kThreads)
attn_ones_column_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
                        __nv_bfloat16* __restrict__ o, int S, int T, Strides st, Blocking bl) {
  constexpr int kStride = D + 8;
  constexpr int kOutTiles = D / 8;
  constexpr int kAccTiles = kOutTiles + 1;  // the last holds the row sums in its column 0

  __shared__ __align__(16) __nv_bfloat16 sQ[kBlockM * kStride];
  __shared__ __align__(16) __nv_bfloat16 sK[kBlockN * kStride];
  __shared__ __align__(16) __nv_bfloat16 sV[kBlockN * kStride];

  // [v | 1 0 0 0 0 0 0 0]: the 8 pad columns of every V row, written once;
  // load_tile only ever writes the D columns in front of them.
  for (int r = threadIdx.x; r < kBlockN; r += kThreads)
    *reinterpret_cast<uint4*>(sV + r * kStride + D) = make_uint4(0x3F80u, 0u, 0u, 0u);

  const Cell cell = block_cell(bl);
  const int m0 = cell.qt * kBlockM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tig = lane % 4;
  const int r0 = warp * 16 + g;
  const unsigned short* sVraw = reinterpret_cast<const unsigned short*>(sV);

  for (int pair = 0; pair < bl.bg * bl.hg; ++pair) {
    const int b = cell.bgi * bl.bg + pair / bl.hg;
    const int h = cell.hgi * bl.hg + pair % bl.hg;

    // (no barrier needed in front: see attn_variant_kernel)
    load_tile<D, kBlockM, kThreads>(sQ, q + b * st.q[0] + h * st.q[2] + m0 * st.q[1], st.q[1],
                                    S - m0);
    __syncthreads();
    uint32_t qa[D / 16][4];
    read_q_frags<D>(qa, sQ, r0, tig);

    float acc[kAccTiles][4];
#pragma unroll
    for (int nt = 0; nt < kAccTiles; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    float row_max[2] = {-INFINITY, -INFINITY};

    const __nv_bfloat16* kbase = k + b * st.k[0] + h * st.k[2];
    const __nv_bfloat16* vbase = v + b * st.v[0] + h * st.v[2];

    for (int n0 = 0; n0 < T; n0 += kBlockN) {
      __syncthreads();
      load_tile<D, kBlockN, kThreads>(sK, kbase + n0 * st.k[1], st.k[1], T - n0);
      load_tile<D, kBlockN, kThreads>(sV, vbase + n0 * st.v[1], st.v[1], T - n0);
      __syncthreads();

      float s[kScoreTiles][4];
      qk_scores<D>(s, qa, sK, g, tig);

      float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < kScoreTiles; ++nt) {
        if (mask != nullptr) {
          const float2 mk = *reinterpret_cast<const float2*>(mask + n0 + nt * 8 + tig * 2);
          s[nt][0] += mk.x;
          s[nt][1] += mk.y;
          s[nt][2] += mk.x;
          s[nt][3] += mk.y;
        }
        if constexpr (!SKIP_MAX) {
          tile_max[0] = fmaxf(tile_max[0], fmaxf(s[nt][0], s[nt][1]));
          tile_max[1] = fmaxf(tile_max[1], fmaxf(s[nt][2], s[nt][3]));
        }
      }
      float shift[2] = {0.f, 0.f};
      if constexpr (!SKIP_MAX) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float new_max = fmaxf(row_max[r], group4_max(tile_max[r]));
          const float corr = exp2f(row_max[r] - new_max);
          row_max[r] = new_max;
          shift[r] = new_max;
#pragma unroll
          for (int nt = 0; nt < kAccTiles; ++nt) {
            acc[nt][2 * r] *= corr;
            acc[nt][2 * r + 1] *= corr;
          }
        }
      }
      uint32_t pa[kKeySteps][4];
#pragma unroll
      for (int nt = 0; nt < kScoreTiles; ++nt) {
        pa[nt / 2][(nt % 2) * 2 + 0] =
            pack_f32x2(exp2f(s[nt][0] - shift[0]), exp2f(s[nt][1] - shift[0]));
        pa[nt / 2][(nt % 2) * 2 + 1] =
            pack_f32x2(exp2f(s[nt][2] - shift[1]), exp2f(s[nt][3] - shift[1]));
      }
      pv_accumulate<kAccTiles, kStride>(acc, pa, sVraw, g, tig);
    }

    // column D of the accumulator (tile kOutTiles, column 0) sits in the
    // group's first thread: rows g and g + 8 in elements 0 and 2
    const float inv0 = 1.f / __shfl_sync(0xffffffffu, acc[kOutTiles][0], lane & ~3);
    const float inv1 = 1.f / __shfl_sync(0xffffffffu, acc[kOutTiles][2], lane & ~3);
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

// The grid of a launch, or false when hg / bg do not divide H / B.
bool make_blocking(int B, int S, int H, int hg, int bg, int head_fastest, Blocking* bl,
                   unsigned* blocks) {
  if (hg < 1 || bg < 1 || H % hg || B % bg) return false;
  bl->hg = hg;
  bl->bg = bg;
  bl->n_qt = (S + kBlockM - 1) / kBlockM;
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
  if (D != 64 || !make_blocking(B, S, H, hg, bg, head_fastest, &bl, &blocks))
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

// S3. As above, with q already scaled by D^-1/2 * log2(e) and `mask` an f32
// row of ceil(T / 64) * 64 entries (or null: nothing masked).
extern "C" int tvs_attn_ones_column(const void* q, const void* k, const void* v, const void* mask,
                                    void* o, int B, int S, int T, int H, int D, int skip_max,
                                    int hg, int bg, int head_fastest, const long long* strides,
                                    void* stream) {
  Blocking bl;
  unsigned blocks;
  if (D != 64 || !make_blocking(B, S, H, hg, bg, head_fastest, &bl, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st = make_strides(strides);
  const cudaStream_t sm = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(k);
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(v);
  const float* mp = static_cast<const float*>(mask);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(o);
  if (skip_max)
    attn_ones_column_kernel<64, true><<<blocks, kThreads, 0, sm>>>(qp, kp, vp, mp, op, S, T, st, bl);
  else
    attn_ones_column_kernel<64, false><<<blocks, kThreads, 0, sm>>>(qp, kp, vp, mp, op, S, T, st, bl);
  return static_cast<int>(cudaGetLastError());
}
