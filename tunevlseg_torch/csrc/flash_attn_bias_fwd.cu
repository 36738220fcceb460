// K3: biased / cross-attention forward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the Pallas TPU kernel tunevlseg_tpu/ops/flash_attention.py:
// _forward. It computes the same function,
//
//     o = softmax(q k^T * D^-1/2 + bias) v,   keys at index >= t_valid get p = 0,
//
// for q (B, S, H, D) against k, v (B, T, H, D) with S != T allowed, D = 16,
// 32, 64 or 96, and an optional f32 bias broadcastable to (B, H, S, T), with the
// same numerics: scores, the bias add and the softmax in f32, p = exp(x - m)
// cast to bf16 for the PV product (f32 accumulation), the denominator the f32
// sum of the UNROUNDED p, o = acc times the row's reciprocal denominator,
// rounded once. Its users are short: the text towers' causal + padding
// attention (S = T = 77) and the CRIS decoder's cross-attention from 676
// visual tokens into 77 text tokens with a key-padding bias. K3 has no
// backward kernel (nor has the TPU kernel): its gradient recomputes through
// the plain attention.
//
// The TPU kernel folds (B, S, H, D) to (B*H, S, D), pads D to 64 and T to 128
// and materialises the bias at (B*H, S, T) in HBM (107 MB of f32 at the cross
// shape). None of that is carried over: q, k, v and o are read in place
// through their strides, and the bias through ITS strides, with stride 0 on
// every broadcast dimension, so a (B, 1, 1, T) key-padding bias costs B*T
// floats of traffic, served from L2 after the first block.
//
// Bound at the path's shapes: the cross shape (b64, S 676, T 77, h8, d64) does
// 4*B*H*S*T*D = 6.8 GFLOP against 98.7 MB of q, k, v, o and bias, 69
// FLOP/byte: under the H100's bf16 ridge of ~295, so streaming q in and o out
// bounds it (29.5 us at 3.35 TB/s). The text shape (U rows of 77 tokens) is a
// few hundred KB: a few microseconds of device time under the host's launch.
//
// Design: the structure of K1's Hopper forward body (attn_fwd_hopper.cuh) on
// attn_hopper.cuh's building blocks, cut for short key sequences. A block is
// one producer warp and two consumer warpgroups of 64 query rows; it owns one
// (batch, head) pair and a run of consecutive 128-row query tiles of it (the
// run chosen on the host so that the card's waves of blocks come out even:
// the CRIS cross shape takes all six tiles of a pair in one block, 512
// blocks). Keys come in tiles of 80, so that the text's 77 keys are ONE tile
// (s = q k^T is one m64n80k16 wgmma per 16 dims, o += p v five k-steps of
// 16 keys), and up to two tiles (t_valid <= 160) stay resident in shared
// memory for the whole block: the producer loads K and V once per block and
// then streams the query tiles past them through a double-buffered Q, so the
// next tile's TMA load runs under this tile's products and epilogue. Longer
// key sequences stream through the two-stage K / V ring per query tile, as
// in K1. Rows past S and keys past t_valid arrive as zeros (the maps end
// there); the keys >= t_valid are then set to -inf by compare-and-select. p is
// repacked in registers as the A operand of the PV wgmma, V read MN-major
// through the transpose bit; the epilogue stages the rows in shared memory
// and stores 16 bytes a thread. One block per SM. At D = 96 (the
// TransformerSegmentor's SigLIP decoder, 484 queries into 64 text keys) a
// tile is three column chunks of 32 (attn_hopper.cuh, `Cols`: a 192-byte row
// has no swizzle mode): three TMA boxes a tile, the score product's six
// k-steps walking them, o += p v as three n32 products a k-step.
//
// Where the bias makes the softmax differ from K1's:
//   * the maximum is taken over x = s * scale + bias, element by element (K1
//     scales the raw maximum once: exact only without an additive term);
//   * the subtraction stays in the natural domain, p = exp2((x - m) * log2 e):
//     folding log2(e) into the scale and the bias, as K1 does, would turn a
//     dtype-min bias entry into -inf, and a row whose entries are all
//     dtype-min must keep the TPU kernel's uniform p;
//   * the running maximum can still be -inf after a whole key tile (a general
//     bias, or a causal + padding bias where min + min overflowed to -inf): a
//     maximum of -inf is replaced by 0 in the rescale and the exponent, so
//     -inf - -inf never appears;
//   * the bias is not read by TMA (its 77-float rows are 308 bytes, not a
//     multiple of 16): each thread loads the elements its accumulator holds
//     while the score product runs; a bias that is the same for every query
//     row (the cross-attention's key padding) over one key tile is loaded once
//     for the block's whole run of query tiles.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see tunevlseg_torch/ops/build.py). Plain C entry point,
// loaded with ctypes; the tensor maps are encoded on the host in it.

#include "attn_fwd_hopper.cuh"  // Strides; the building blocks of attn_hopper.cuh

namespace {

using namespace tvs;

constexpr int kBM = 128;       // query rows per Q tile, 64 per consumer warpgroup
constexpr int kBN = 80;        // keys per K / V tile: the text's 77 in one
constexpr int kQStages = 2;    // the next query tile loads under this one
constexpr int kKvStages = 2;   // K / V tiles in shared memory: resident up to 160 keys
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kMinBlocks = 1;              // blocks per SM the registers are fitted to
constexpr float kLog2e = 1.4426950408889634f;

// 2^x in one MUFU op (results under 2^-126 flushed to 0: p that small is 0
// in the bf16 PV operand anyway)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr int round_1k(int bytes) { return (bytes + 1023) / 1024 * 1024; }

// Shared memory: the Q ring (128 rows a stage), the K and V slots, the output
// staging (two warpgroups' 64 rows of D + 8), the barriers. Every TMA
// destination sits at a multiple of 1024 bytes from the aligned base.
template <int D>
struct Smem {
  static constexpr int kSwizzle = Cols<D>::kSwizzle;      // bytes of a chunk row: the maps' swizzle
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kQPitch = kBM * Cols<D>::kW * 2;   // a column chunk of a Q tile
  static constexpr int kWgQBytes = 64 * Cols<D>::kW * 2;  // a warpgroup's rows of a Q chunk
  static constexpr int kKvBytes = kBN * D * 2;            // a K or V tile
  static constexpr int kKvChunk = kBN * Cols<D>::kW * 2;  // a column chunk of it
  static_assert(Cols<D>::kN == 1 || kKvChunk % 1024 == 0, "chunks 1024-byte aligned");
  static constexpr int kKvPitch = round_1k(kKvBytes);
  static constexpr int kOutStride = D + 8;        // bf16 staging rows, padded against bank conflicts
  static constexpr int kQOff = 0;
  static constexpr int kKOff = kQOff + kQStages * kQBytes;
  static constexpr int kVOff = kKOff + kKvStages * kKvPitch;
  static constexpr int kOutOff = kVOff + kKvStages * kKvPitch;
  static constexpr int kBarOff = kOutOff + 2 * 64 * kOutStride * 2;
  static constexpr int kBytes = kBarOff + 2 * (kKvStages + kQStages) * 8 + 1024;  // + alignment slack
};

struct Params {
  const float* bias;  // null without a bias
  long long bs[4];    // the bias's (batch, head, query, key) strides, 0 where it broadcasts
  long long os[3];    // o's (batch, seq, head) strides
  int S, H;
  int t_valid;        // keys >= t_valid are masked
  int n_kt;           // key tiles: ceil(t_valid / kBN)
  int n_qt;           // query tiles of a pair: ceil(S / kBM)
  int run;            // query tiles a block takes
  int runs;           // blocks a pair takes: ceil(n_qt / run)
  float scale;        // D^-1/2
};

template <int D, bool kBias>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
biased_attn_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                       const Params p) {
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* kv_empty = kv_full + kKvStages;
  uint64_t* q_full = kv_empty + kKvStages;
  uint64_t* q_empty = q_full + kQStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kKvStages; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], kConsumers / 32);  // one arrival per consumer warp
    }
    for (int s = 0; s < kQStages; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], kConsumers / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int pair = blockIdx.x / p.runs;
  const int b = pair / p.H;
  const int h = pair % p.H;
  const int qt0 = (blockIdx.x % p.runs) * p.run;
  const int n_q = min(p.run, p.n_qt - qt0);
  // every key tile fits: K and V are loaded once and stay for the block's run
  const bool resident = p.n_kt <= kKvStages;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp == kConsumers / 32) {
    if (lane == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      if (resident) {
        for (int n = 0; n < p.n_kt; ++n) {
          mbar_arrive_expect_tx(&kv_full[n], 2 * L::kKvBytes);
          tma_load_rows<D>(smem + L::kKOff + n * L::kKvPitch, L::kKvChunk, &tm_k, &kv_full[n], h,
                           n * kBN, b);
          tma_load_rows<D>(smem + L::kVOff + n * L::kKvPitch, L::kKvChunk, &tm_v, &kv_full[n], h,
                           n * kBN, b);
        }
      }
      int it = 0;
      for (int j = 0; j < n_q; ++j) {
        const int qs = j % kQStages;
        mbar_wait(&q_empty[qs], ((j / kQStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&q_full[qs], L::kQBytes);
        tma_load_rows<D>(smem + L::kQOff + qs * L::kQBytes, L::kQPitch, &tm_q, &q_full[qs], h,
                         (qt0 + j) * kBM, b);
        if (resident) continue;
        for (int n = 0; n < p.n_kt; ++n, ++it) {
          const int s = it % kKvStages;
          mbar_wait(&kv_empty[s], ((it / kKvStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&kv_full[s], 2 * L::kKvBytes);
          tma_load_rows<D>(smem + L::kKOff + s * L::kKvPitch, L::kKvChunk, &tm_k, &kv_full[s], h,
                           n * kBN, b);
          tma_load_rows<D>(smem + L::kVOff + s * L::kKvPitch, L::kKvChunk, &tm_v, &kv_full[s], h,
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
  __nv_bfloat16* obase = o + b * p.os[0] + h * p.os[2];
  const float* bias_bh = kBias ? p.bias + b * p.bs[0] + h * p.bs[1] : nullptr;
  // the bias of the thread's elements of a key tile, rows past S clamped to
  // the last row (their output is dropped), keys past t_valid to the last
  // valid key (they are masked)
  float bv[kBN / 2];
  const auto load_bias = [&](int m0, int key0) {
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      const int row = min(m0 + at.row + 8 * acc_row_half(i), p.S - 1);
      const int key = min(key0 + acc_col(i, at.col), p.t_valid - 1);
      bv[i] = __ldg(bias_bh + row * p.bs[2] + key * p.bs[3]);
    }
  };
  // a bias the same for every query row (the key-padding bias) over one key
  // tile is the same for every query tile of the run: loaded once
  const bool bias_once = kBias && p.bs[2] == 0 && p.n_kt == 1;
  if (bias_once) load_bias(0, 0);
  int it = 0;
  for (int j = 0; j < n_q; ++j) {
    const int qs = j % kQStages;
    const int m0 = (qt0 + j) * kBM + wg * 64;  // the warpgroup's first query row
    const uint64_t desc_q =
        kmajor_desc(smem + L::kQOff + qs * L::kQBytes + wg * L::kWgQBytes, L::kSwizzle);
    mbar_wait(&q_full[qs], (j / kQStages) & 1);

    float acc[D / 2];
    zero(acc);
    float m[2] = {-INFINITY, -INFINITY};  // running maximum of x = s * scale + bias
    float sum[2] = {0.f, 0.f};            // this thread's share of the denominator
    for (int n = 0; n < p.n_kt; ++n, ++it) {
      const int s = resident ? n : it % kKvStages;
      mbar_wait(&kv_full[s], resident ? 0 : (it / kKvStages) & 1);
      float sc[kBN / 2];
      zero(sc);
      fence_operands(sc);
      wgmma_fence();
      const uint64_t desc_k = kmajor_desc(smem + L::kKOff + s * L::kKvPitch, L::kSwizzle);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64k16<kBN>(sc, kstep_desc<D>(desc_q, L::kQPitch, kk),
                          kstep_desc<D>(desc_k, L::kKvChunk, kk));
      wgmma_commit();
      const int key0 = n * kBN;
      if (kBias && !bias_once) load_bias(m0, key0);  // while the product runs
      wgmma_wait<0>();
      fence_operands(sc);
      // the tile's last read of its Q stage: both warpgroups' warps release it
      if (n == p.n_kt - 1 && lane == 0) mbar_arrive(&q_empty[qs]);

      // x = s * scale + bias in f32; keys >= t_valid (zero-filled past the
      // maps' end) at -inf
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        float x = sc[i] * p.scale;
        if constexpr (kBias) x += bv[i];
        sc[i] = key0 + acc_col(i, at.col) < p.t_valid ? x : -INFINITY;
      }
      float shift[2];
      {
        float tile_max[2];
        acc_row_max(sc, tile_max);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mx = fmaxf(m[r], tile_max[r]);
          shift[r] = mx == -INFINITY ? 0.f : mx;
          const float corr = exp2_ftz((m[r] - shift[r]) * kLog2e);
          m[r] = mx;
          sum[r] *= corr;
#pragma unroll
          for (int i = 0; i < D / 2; ++i)
            if (acc_row_half(i) == r) acc[i] *= corr;
        }
      }
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        const float e = exp2_ftz((sc[i] - shift[acc_row_half(i)]) * kLog2e);
        sum[acc_row_half(i)] += e;
        sc[i] = e;
      }
      uint32_t pa[kBN / 16][4];
      acc_to_a<kBN>(sc, pa);

      fence_operands(acc);
      wgmma_fence();
      const uint64_t mn_v = mnmajor_desc(smem + L::kVOff + s * L::kKvPitch, L::kSwizzle);
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) wgmma_rs_cols<D>(acc, pa[kk], mn_v, L::kKvChunk, kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) fence_operands(pa[kk]);
      if (!resident && lane == 0) mbar_arrive(&kv_empty[s]);
    }

    // o = acc / denominator: one division a row, then products
    const float inv[2] = {1.f / group4_sum(sum[0]), 1.f / group4_sum(sum[1])};
    named_barrier(1 + wg, 128);  // the last tile's reads of the staging rows are done
    store_acc_rows<D>(stage, L::kOutStride, acc, inv, 0, 64, at);
    named_barrier(1 + wg, 128);
    for (int i = t; i < 64 * D / 8; i += 128) {
      const int r = i / (D / 8);
      const int c = (i % (D / 8)) * 8;
      if (m0 + r < p.S)
        *reinterpret_cast<uint4*>(obase + (m0 + r) * p.os[1] + c) =
            *reinterpret_cast<const uint4*>(stage + r * L::kOutStride + c);
    }
  }
}

// The query tiles a block takes: the fewest waves of kMinBlocks blocks per SM
// times the tiles a block runs, ties to the longer run (fewer loads of K and V
// per pair).
int query_run(long long pairs, int n_qt, int sms) {
  const long long slots = static_cast<long long>(kMinBlocks) * sms;
  int best = 1;
  long long best_cost = -1;
  for (int run = 1; run <= n_qt; ++run) {
    const long long blocks = pairs * ((n_qt + run - 1) / run);
    const long long cost = (blocks + slots - 1) / slots * run;
    if (best_cost < 0 || cost <= best_cost) {
      best_cost = cost;
      best = run;
    }
  }
  return best;
}

template <int D, bool kBias>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias, void* o, int B,
                   int S, int H, int t_valid, const long long* strides,
                   const long long* bias_strides, cudaStream_t stream) {
  using L = Smem<D>;
  cudaError_t err = make_context_current();  // the maps' encoding needs a current context
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const Strides st = make_strides(strides);
  Params p;
  p.bias = bias;
  for (int i = 0; i < 4; ++i) p.bs[i] = kBias ? bias_strides[i] : 0;
  for (int i = 0; i < 3; ++i) p.os[i] = st.o[i];
  p.S = S;
  p.H = H;
  p.t_valid = t_valid;
  p.n_kt = (t_valid + kBN - 1) / kBN;
  p.n_qt = (S + kBM - 1) / kBM;
  p.run = query_run(static_cast<long long>(B) * H, p.n_qt, sms);
  p.runs = (p.n_qt + p.run - 1) / p.run;
  p.scale = 1.0f / sqrtf(static_cast<float>(D));
  // the keys' maps end at t_valid: the keys past it are masked anyway
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode_bshd(&tm_q, q, B, S, H, D, st.q, kBM) ||
      !encode_bshd(&tm_k, k, B, t_valid, H, D, st.k, kBN) ||
      !encode_bshd(&tm_v, v, B, t_valid, H, D, st.v, kBN))
    return cudaErrorNotSupported;
  const auto kernel = biased_attn_fwd_kernel<D, kBias>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(B) * H * p.runs);
  kernel<<<blocks, kThreads, L::kBytes, stream>>>(tm_q, tm_k, tm_v,
                                                   static_cast<__nv_bfloat16*>(o), p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const void* bias, void* o,
                     int B, int S, int H, int t_valid, const long long* strides,
                     const long long* bias_strides, cudaStream_t stream) {
  const float* bp = static_cast<const float*>(bias);
  return bias ? launch<D, true>(q, k, v, bp, o, B, S, H, t_valid, strides, bias_strides, stream)
              : launch<D, false>(q, k, v, bp, o, B, S, H, t_valid, strides, bias_strides, stream);
}

}  // namespace

// q and o (B, S, H, D), k and v (B, T, H, D), all bf16 with unit stride on D,
// 16-byte aligned bases and strides that are multiples of 8 elements (TMA
// reads them in place). `strides` holds the (batch, seq, head) strides in
// elements of q, k, v and o, in that order (12 values). `bias` is null or f32,
// read as (B, H, S, T) through `bias_strides` (4 values in elements, 0 on a
// broadcast dimension). Keys at index >= t_valid are masked (t_valid =
// kv_valid, or T). Returns the cudaError_t of the launch
// (cudaErrorNotSupported if a tensor map could not be encoded).
extern "C" int tvs_biased_attn_fwd(const void* q, const void* k, const void* v, const void* bias,
                                   void* o, int B, int S, int H, int D, int t_valid,
                                   const long long* strides, const long long* bias_strides,
                                   void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || t_valid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return static_cast<int>(
          launch_d<16>(q, k, v, bias, o, B, S, H, t_valid, strides, bias_strides, st));
    case 32:
      return static_cast<int>(
          launch_d<32>(q, k, v, bias, o, B, S, H, t_valid, strides, bias_strides, st));
    case 64:
      return static_cast<int>(
          launch_d<64>(q, k, v, bias, o, B, S, H, t_valid, strides, bias_strides, st));
    case 96:
      return static_cast<int>(
          launch_d<96>(q, k, v, bias, o, B, S, H, t_valid, strides, bias_strides, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
