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
// Bound: as K1. At b64 S = T = 485 h12 d64 the call does 46 GFLOP against
// 191 MB of q, k, v and o: bound by bytes (57 us at 3.35 TB/s), by a small
// margin over the tensor cores (46 us at 989 TFLOP/s).
//
// S1, S2 and S4 (attn_variant_kernel) are K1's own body (attn_fwd_hopper.cuh:
// one producer warp feeding two consumer warpgroups of 64 query rows through
// a TMA / mbarrier ring, wgmma for both products with p kept in registers,
// two blocks per SM) at D = 64, with the switches as the body's compile-time
// softmax policy; what they mean on this card:
//   * "hg heads / bg batch rows per grid cell" is a block that owns one query
//     tile of 128 rows and loops over its bg x hg (batch, head) pairs, the
//     next pair's Q tile and keys streaming in behind the last: fewer, longer
//     blocks. hg and bg are launch parameters, the loop is the same code.
//   * `dimension_semantics` has no meaning in CUDA. Its counterpart is the
//     order in which blockIdx maps to (batch group, head group, query tile):
//     query-tile-fastest, so that neighbouring blocks share one head's K and V
//     in L2, or head-fastest. A launch parameter.
//   * USE_EXP2: p = exp2(s * scale * log2(e) - m) against expf(s * scale - m).
//     With hg = bg = 1 and the query-tile-fastest order it is K1's launch.
//   * SKIP_MAX: no running maximum and no rescale of the accumulator,
//     p = exp(s). An experiment, as in the script: it overflows for scores
//     above ~88 (~128 with exp2).
//   * GEMM_ONLY: o = (q k^T * scale) v over all T keys, no softmax, no mask
//     (the keys past T arrive as zeros and add nothing).
// S3 (attn_ones_column_kernel) is built the same way on the attention
// building blocks of attn_hopper.cuh, with its own recipe: q is multiplied by
// the bf16 factor D^-1/2 * log2(e) (in the kernel, on the Q tile in shared
// memory); an f32 mask row (0 on valid keys, -1e30 beyond; padded to whole
// key tiles of 64) is added to the scores in the place of the
// compare-and-select; the denominator comes out of the P V step, as an n8
// product of the same bf16 p against a constant [1, 0, ..., 0] tile, rescaled
// with the output like any of its columns; the epilogue multiplies by its
// reciprocal. The sum is of the bf16-ROUNDED p, accumulated in f32: it
// differs from K1's f32 sum of the unrounded p by at most about 2^-9 relative.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC into a library of its own (tunevlseg_torch/ops/build.py),
// so that a process that never sweeps never builds it. Plain C entry points,
// loaded with ctypes (tunevlseg_torch/ops/flash_attention_variants.py).

#include "attn_fwd_hopper.cuh"

namespace {

using namespace tvs;

// S1, S2, S4: the forward body at D = 64 with the switches as its policy.
template <bool USE_EXP2, bool SKIP_MAX, bool GEMM_ONLY>
__global__ void __launch_bounds__(fwd::kThreads, fwd::kMinBlocks)
attn_variant_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                    float* __restrict__ lse, const fwd::Params p) {
  fwd::attn_fwd_body<64, fwd::Policy<USE_EXP2, !SKIP_MAX, !GEMM_ONLY>>(&tm_q, &tm_k, &tm_v, o,
                                                                       lse, p);
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

template <bool USE_EXP2, bool SKIP_MAX, bool GEMM_ONLY>
cudaError_t launch_variant(const void* q, const void* k, const void* v, void* o, int B, int T,
                           const Strides& st, fwd::Params p, unsigned blocks,
                           cudaStream_t stream) {
  p.scale = 1.0f / sqrtf(64.f);
  if (USE_EXP2) p.scale *= 1.4426950408889634f;
  // the two products alone run over every key; the softmax over the valid ones
  p.n_tiles = ((GEMM_ONLY ? T : p.t_valid) + fwd::kBN - 1) / fwd::kBN;
  return fwd::launch_fwd<64>(attn_variant_kernel<USE_EXP2, SKIP_MAX, GEMM_ONLY>, q, k, v, o,
                             nullptr, B, T, st, p, blocks, stream);
}

}  // namespace

// S1, S2, S4. q (B, S, H, 64), k and v (B, T, H, 64), o (B, S, H, 64), bf16
// with unit stride on the last dimension, read in place by TMA (16-byte
// aligned, strides multiples of 8 elements); `strides` as in
// tvs_flash_attn_fwd (12 values). `flags`: bit 0 USE_EXP2, bit 1 SKIP_MAX,
// bit 2 GEMM_ONLY (alone). hg heads and bg batch rows per block (they must
// divide H and B); head_fastest picks the block order. Returns the
// cudaError_t of the launch (cudaErrorNotSupported if a tensor map could not
// be encoded).
extern "C" int tvs_attn_variant(const void* q, const void* k, const void* v, void* o, int B, int S,
                                int T, int H, int D, int t_valid, int flags, int hg, int bg,
                                int head_fastest, const long long* strides, void* stream) {
  fwd::Params p;
  unsigned blocks;
  if (D != 64 || S <= 0 || T <= 0 || t_valid < 1 || t_valid > T ||
      !make_blocking(B, S, H, hg, bg, head_fastest, fwd::kBM, &p.bl, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st = make_strides(strides);
  p.S = S;
  p.t_valid = t_valid;
  p.H = H;
  for (int i = 0; i < 3; ++i) p.os[i] = st.o[i];
  const cudaStream_t sm = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (flags) {
    case 0: err = launch_variant<false, false, false>(q, k, v, o, B, T, st, p, blocks, sm); break;
    case 1: err = launch_variant<true, false, false>(q, k, v, o, B, T, st, p, blocks, sm); break;
    case 2: err = launch_variant<false, true, false>(q, k, v, o, B, T, st, p, blocks, sm); break;
    case 3: err = launch_variant<true, true, false>(q, k, v, o, B, T, st, p, blocks, sm); break;
    case 4: err = launch_variant<false, false, true>(q, k, v, o, B, T, st, p, blocks, sm); break;
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
