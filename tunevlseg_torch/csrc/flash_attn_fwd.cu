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
// When a backward will follow, K1 also writes each row's log-sum-exp in its
// log2 domain, lse2 = row_max + log2(row_sum) (f32, (B, H, S)), which K2
// (flash_attn_bwd.cu) turns into p = exp2(s2 - lse2) without a sweep of its
// own: the scores are scaled by the same f32 product D^-1/2 * log2(e) as K2
// scales its own. A null pointer writes nothing; o is the same bits either
// way.
//
// Bound on this card. At the serving shapes (b64, S = T = 485) the vision
// tower's h12 d64 does 4*B*H*S*T*D = 46 GFLOP per layer against 191 MB of q,
// k, v and o: 57 us of HBM traffic at 3.35 TB/s against 46 us of bf16 tensor
// cores at 989 TFLOP/s, bound by bytes by a small margin; the decoder (h4 d16)
// has the same ratio; so has the TransformerSegmentor's SigLIP decoder (b32,
// S = T = 484, h8 d96: 23.0 GFLOP against 95.2 MB a layer, 23.3 against 28.4
// us). The S x T scores never reach HBM.
//
// Design: the shared Hopper forward body of attn_fwd_hopper.cuh (which the
// sweeps' variants S1, S2 and S4 instantiate too), with K1's softmax: exp2
// domain, online maximum, denominator. One producer warp brings each block's
// 128-row Q tile by TMA and streams K and V tiles of 64 keys through a
// 3-stage mbarrier ring; two consumer warpgroups of 64 query rows run both
// products on wgmma (s = q k^T from shared memory, o += p v with p repacked
// in registers as the A operand and V read MN-major), so the tensor cores run
// at their Hopper rate and the loads overlap the math. q, k, v are read in
// place in their (B, S, H, D) layout through 4-D tensor maps over their
// strides: rows past S and keys past t_valid come back as zeros (the keys
// past t_valid are masked to -inf before the softmax), so there are no
// padding copies and no row predicates but the output's. Two blocks per SM
// (the registers are fitted to it: __launch_bounds__), one at D = 96, whose
// tiles are three column chunks of 32 (a 192-byte row has no swizzle mode;
// attn_hopper.cuh, `Cols`).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see tunevlseg_torch/ops/build.py). Plain C entry point,
// loaded with ctypes; the tensor maps are encoded on the host in it.

#include "attn_fwd_hopper.cuh"

namespace {

using namespace tvs;

using K1Softmax = fwd::Policy</*EXP2=*/true, /*MAX=*/true, /*SOFTMAX=*/true>;

template <int D>
__global__ void __launch_bounds__(fwd::kThreads, fwd::min_blocks<D>())
flash_attn_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, const fwd::Params p) {
  fwd::attn_fwd_body<D, K1Softmax>(&tm_q, &tm_k, &tm_v, o, lse, p);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
                   int H, int t_valid, const long long* strides, cudaStream_t stream) {
  fwd::Params p;
  unsigned blocks;
  make_blocking(B, S, H, 1, 1, 0, fwd::kBM, &p.bl, &blocks);  // one (batch, head) a block
  const Strides st = make_strides(strides);
  p.S = S;
  p.t_valid = t_valid;
  p.n_tiles = (t_valid + fwd::kBN - 1) / fwd::kBN;
  p.scale = (1.0f / sqrtf(static_cast<float>(D))) * 1.4426950408889634f;
  for (int i = 0; i < 3; ++i) p.os[i] = st.o[i];
  p.H = H;
  // the keys' maps end at t_valid: the keys past it are masked anyway
  return fwd::launch_fwd<D>(flash_attn_fwd_kernel<D>, q, k, v, o, lse, B, t_valid, st, p, blocks,
                            stream);
}

}  // namespace

// q (B, S, H, D), k and v (B, T, H, D), o (B, S, H, D), all bf16 with unit
// stride on D, 16-byte aligned bases and strides that are multiples of 8
// elements (TMA reads them in place). `strides` holds the (batch, seq, head)
// strides in elements of q, k, v and o, in that order (12 values). Keys at
// index >= t_valid are masked (t_valid = kv_valid, or T). lse is null or f32
// (B, H, S), each row's log2-domain log-sum-exp. Returns the cudaError_t of
// the launch (cudaErrorNotSupported if a tensor map could not be encoded).
extern "C" int tvs_flash_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                                  int B, int S, int H, int D, int t_valid,
                                  const long long* strides, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || t_valid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lp = static_cast<float*>(lse);
  switch (D) {
    case 16: return static_cast<int>(launch<16>(q, k, v, o, lp, B, S, H, t_valid, strides, st));
    case 32: return static_cast<int>(launch<32>(q, k, v, o, lp, B, S, H, t_valid, strides, st));
    case 64: return static_cast<int>(launch<64>(q, k, v, o, lp, B, S, H, t_valid, strides, st));
    case 96: return static_cast<int>(launch<96>(q, k, v, o, lp, B, S, H, t_valid, strides, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
