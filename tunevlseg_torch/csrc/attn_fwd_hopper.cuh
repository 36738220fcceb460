// The attention forward body for Hopper (sm_90a) that K1 (flash_attn_fwd.cu)
// and the sweeps' variants S1, S2 and S4 (attn_variant_kernel in
// flash_attn_fwd_variants.cu) instantiate: o = softmax(q k^T * scale) v for
// bf16 (B, S, H, D) tensors, D = 16, 32, 64 or 96, with the softmax's
// choices as a compile-time policy. A 96-wide tile is kept as three column
// chunks of 32 (attn_hopper.cuh, `Cols`): three TMA boxes a tile, the score
// product's six k-steps walking them, o += p v as three n32 products a
// k-step; one block per SM there (the Q tile, the rings and the staging take
// 125 KB of shared memory).
//
// A block is one producer warp and two consumer warpgroups and owns 128
// query rows (64 per warpgroup) of each of its (batch, head) pairs; which
// pairs and which query tile is `Blocking`'s business (hg heads x bg batch
// rows a block, query-tile- or head-fastest block order; K1 takes one pair a
// block, query tile fastest, so that neighbouring blocks share a head's K
// and V in L2). The producer brings the pair's Q tile by TMA once (after both
// warpgroups released the last one) and streams K and V tiles of 64 keys
// through a ring of kStages stages (full / empty mbarriers); rows past S and
// keys past the map's length arrive as zeros. Per key tile a warpgroup forms
// s = q k^T (wgmma m64n64k16, both operands K-major, D / 16 k-steps), masks
// the keys >= t_valid by compare-and-select to -inf (in the one tile that has
// such keys), takes the online softmax in registers, repacks p as the
// register A operand of o += p v (V read MN-major through the transpose bit;
// p never touches shared memory), and releases the stage. The epilogue
// divides by the denominator, stages the rows in shared memory and stores 16
// bytes a thread; with `lse` it also writes each row's log-sum-exp in the
// log2 domain.
//
// The softmax's numerics (K1's; attention_variant_ref and
// flash_attention_ref repeat them): scores in f32, scaled in f32 (by D^-1/2,
// times log2(e) in the exp2 domain); the running maximum m of the scaled
// scores, taken as the scaled maximum of the raw ones (the scale is positive
// and rounding is monotonic: the same value, one product a row instead of 32);
// p = exp2 (or exp) of s * scale - m, one fused multiply-add, as K2 forms its
// p = exp2(s * scale - lse); the denominator the f32 sum of the UNROUNDED p,
// each thread's share rescaled with o and reduced over the four threads of a
// row at the end; p rounded to bf16 only as the operand of the P V product;
// o = acc / denominator, rounded once; lse = m + log2(denominator).
#pragma once

#include "attn_hopper.cuh"

namespace tvs {

// (batch, seq, head) strides in elements of q, k, v and o
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

inline Strides make_strides(const long long* s) {
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = s[i];
    st.k[i] = s[3 + i];
    st.v[i] = s[6 + i];
    st.o[i] = s[9 + i];
  }
  return st;
}

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

// The grid of a launch with `block_m` query rows a block, or false when hg /
// bg do not divide H / B.
inline bool make_blocking(int B, int S, int H, int hg, int bg, int head_fastest, int block_m,
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

namespace fwd {

constexpr int kBM = 128;                   // query rows per block, 64 per consumer warpgroup
constexpr int kBN = 64;                    // keys per ring stage
constexpr int kStages = 3;
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kMinBlocks = 2;              // blocks per SM the registers are fitted to

// the blocks per SM an instance at head dim D is fitted to: at D = 96 the
// shared memory holds one block, and its registers (a 48-value output
// accumulator) get the room of one
template <int D>
constexpr int min_blocks() { return D == 96 ? 1 : kMinBlocks; }

// The softmax's choices. EXP2: the scale carries log2(e) and p = exp2,
// otherwise exp. MAX: the online maximum and the rescale, otherwise
// p = exp(s * scale) as it is (an experiment of the sweeps: it overflows on
// large scores). SOFTMAX: otherwise p = s * scale over every key, unmasked,
// and no denominator (the two products alone).
template <bool EXP2, bool MAX, bool SOFTMAX>
struct Policy {
  static constexpr bool kExp2 = EXP2, kMax = MAX, kSoftmax = SOFTMAX;
};

// Shared memory: the Q tile (128 rows), the K and V rings, the output
// staging (two warpgroups' 64 rows of D + 8), the barriers. Every TMA
// destination sits at a multiple of 1024 bytes from the aligned base.
template <int D>
struct Smem {
  static constexpr int kSwizzle = Cols<D>::kSwizzle;      // bytes of a chunk row: the maps' swizzle
  static constexpr int kTileBytes = kBN * D * 2;          // a K or V tile
  static constexpr int kKvPitch = kBN * Cols<D>::kW * 2;  // a chunk of it
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kQPitch = kBM * Cols<D>::kW * 2;   // a chunk of the Q tile
  static constexpr int kWgQBytes = 64 * Cols<D>::kW * 2;  // a warpgroup's rows of a Q chunk
  static constexpr int kOutStride = D + 8;        // bf16 staging rows, padded against bank conflicts
  static constexpr int kQOff = 0;
  static constexpr int kKOff = kQOff + kQBytes;
  static constexpr int kVOff = kKOff + kStages * kTileBytes;
  static constexpr int kOutOff = kVOff + kStages * kTileBytes;
  static constexpr int kBarOff = kOutOff + 2 * 64 * kOutStride * 2;
  static constexpr int kBytes = kBarOff + (2 * kStages + 2) * 8 + 1024;  // + alignment slack
};

// What a launch passes besides the tensor maps and the pointers.
struct Params {
  int S;          // query rows
  int t_valid;    // keys >= t_valid are masked (the softmax policies)
  int n_tiles;    // key tiles streamed: ceil(t_valid / 64), or ceil(T / 64) without a softmax
  float scale;    // D^-1/2, times log2(e) in the exp2 domain
  long long os[3];  // (batch, seq, head) strides of o
  int H;
  Blocking bl;
};

template <bool EXP2>
__device__ __forceinline__ float expo(float x) {
  if constexpr (EXP2) return exp2f(x);
  else return expf(x);
}

// The kernel's whole work; a __global__ of kThreads threads and Smem<D>::kBytes
// of dynamic shared memory calls it with its __grid_constant__ maps. `lse` is
// null or f32 (B, H, S) (softmax policies with the maximum only).
template <int D, class P>
__device__ __forceinline__ void attn_fwd_body(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                              const CUtensorMap* tm_v, __nv_bfloat16* o,
                                              float* lse, const Params& p) {
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
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
  __syncthreads();

  const Blocking& bl = p.bl;
  const Cell cell = block_cell(bl);
  const int pairs = bl.bg * bl.hg;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp == kConsumers / 32) {
    if (lane == 0) {
      tma_prefetch_map(tm_q);
      tma_prefetch_map(tm_k);
      tma_prefetch_map(tm_v);
      int it = 0;
      for (int pair = 0; pair < pairs; ++pair) {
        const int b = cell.bgi * bl.bg + pair / bl.hg;
        const int h = cell.hgi * bl.hg + pair % bl.hg;
        mbar_wait(q_empty, (pair & 1) ^ 1);
        mbar_arrive_expect_tx(q_full, L::kQBytes);
        tma_load_rows<D>(smem + L::kQOff, L::kQPitch, tm_q, q_full, h, cell.qt * kBM, b);
        for (int n = 0; n < p.n_tiles; ++n, ++it) {
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], 2 * L::kTileBytes);
          tma_load_rows<D>(smem + L::kKOff + s * L::kTileBytes, L::kKvPitch, tm_k, &full[s], h,
                           n * kBN, b);
          tma_load_rows<D>(smem + L::kVOff + s * L::kTileBytes, L::kKvPitch, tm_v, &full[s], h,
                           n * kBN, b);
        }
      }
    }
    return;
  }

  const int wg = warp / 4;
  const int t = threadIdx.x % 128;
  const AccPlace at = acc_place();
  __nv_bfloat16* stage =
      reinterpret_cast<__nv_bfloat16*>(smem + L::kOutOff) + wg * 64 * L::kOutStride;
  const uint64_t desc_q = kmajor_desc(smem + L::kQOff + wg * L::kWgQBytes, L::kSwizzle);
  const int m0 = cell.qt * kBM + wg * 64;  // the warpgroup's first query row
  int it = 0;
  for (int pair = 0; pair < pairs; ++pair) {
    const int b = cell.bgi * bl.bg + pair / bl.hg;
    const int h = cell.hgi * bl.hg + pair % bl.hg;
    mbar_wait(q_full, pair & 1);

    float acc[D / 2];
    zero(acc);
    float m[2] = {-INFINITY, -INFINITY};        // running maximum of s * scale
    float sum[2] = {0.f, 0.f};                  // this thread's share of the denominator
    for (int n = 0; n < p.n_tiles; ++n, ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      float sc[32];
      zero(sc);
      fence_operands(sc);
      wgmma_fence();
      const uint64_t desc_k = kmajor_desc(smem + L::kKOff + s * L::kTileBytes, L::kSwizzle);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n64k16(sc, kstep_desc<D>(desc_q, L::kQPitch, kk),
                        kstep_desc<D>(desc_k, L::kKvPitch, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(sc);
      // the pair's last read of its Q tile: both warpgroups' warps release it
      if (n == p.n_tiles - 1 && lane == 0) mbar_arrive(q_empty);

      if constexpr (P::kSoftmax) {
        // keys >= t_valid (in the last tile only; zero-filled keys past the
        // map's end among them) get -inf: p = 0, and they never reach the max
        const int key_end = p.t_valid - n * kBN;
        if (key_end < kBN) {
#pragma unroll
          for (int i = 0; i < 32; ++i)
            if (acc_col(i, at.col) >= key_end) sc[i] = -INFINITY;
        }
        float shift[2] = {0.f, 0.f};
        if constexpr (P::kMax) {
          float tile_max[2];
          acc_row_max(sc, tile_max);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            // key 0 is always valid, so the maximum is finite after tile 0
            shift[r] = fmaxf(m[r], __fmul_rn(tile_max[r], p.scale));
            const float corr = expo<P::kExp2>(m[r] - shift[r]);
            m[r] = shift[r];
            sum[r] *= corr;
#pragma unroll
            for (int i = 0; i < D / 2; ++i)
              if (acc_row_half(i) == r) acc[i] *= corr;
          }
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float e = expo<P::kExp2>(sc[i] * p.scale - shift[acc_row_half(i)]);
          sum[acc_row_half(i)] += e;
          sc[i] = e;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] *= p.scale;
      }
      uint32_t pa[4][4];
      acc_to_a<64>(sc, pa);

      fence_operands(acc);
      wgmma_fence();
      const uint64_t mn_v = mnmajor_desc(smem + L::kVOff + s * L::kTileBytes, L::kSwizzle);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_cols<D>(acc, pa[kk], mn_v, L::kKvPitch, kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_operands(pa[kk]);
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    if constexpr (P::kSoftmax) {
      const float denom[2] = {group4_sum(sum[0]), group4_sum(sum[1])};
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] /= denom[acc_row_half(i)];
      if constexpr (P::kMax) {
        if (lse != nullptr && at.col == 0) {
          float* lrow = lse + (static_cast<int64_t>(b) * p.H + h) * p.S;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = m0 + at.row + 8 * r;
            if (row < p.S) lrow[row] = m[r] + log2f(denom[r]);
          }
        }
      }
    }
    const float one[2] = {1.f, 1.f};
    named_barrier(1 + wg, 128);  // the last pair's reads of the staging tile are done
    store_acc_rows<D>(stage, L::kOutStride, acc, one, 0, 64, at);
    named_barrier(1 + wg, 128);
    __nv_bfloat16* obase = o + b * p.os[0] + h * p.os[2];
    for (int i = t; i < 64 * D / 8; i += 128) {
      const int r = i / (D / 8);
      const int c = (i % (D / 8)) * 8;
      if (m0 + r < p.S)
        *reinterpret_cast<uint4*>(obase + (m0 + r) * p.os[1] + c) =
            *reinterpret_cast<const uint4*>(stage + r * L::kOutStride + c);
    }
  }
}

// Host side of a launch of `kernel`, an instance of the body at head dim D:
// encodes q's map over S rows and k's and v's over `t_map` rows (boxes of 128
// query rows resp. 64 keys), sets the shared memory and enqueues `blocks`
// blocks on `stream`. Returns the cudaError_t (cudaErrorNotSupported if a map
// could not be encoded).
template <int D, typename Kernel>
cudaError_t launch_fwd(Kernel kernel, const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int t_map, const Strides& st, const Params& p,
                       unsigned blocks, cudaStream_t stream) {
  cudaError_t err = make_context_current();
  if (err != cudaSuccess) return err;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode_bshd(&tm_q, q, B, p.S, p.H, D, st.q, kBM) ||
      !encode_bshd(&tm_k, k, B, t_map, p.H, D, st.k, kBN) ||
      !encode_bshd(&tm_v, v, B, t_map, p.H, D, st.v, kBN))
    return cudaErrorNotSupported;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::kBytes);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, Smem<D>::kBytes, stream>>>(tm_q, tm_k, tm_v,
                                                         static_cast<__nv_bfloat16*>(o), lse, p);
  return cudaGetLastError();
}

}  // namespace fwd
}  // namespace tvs
