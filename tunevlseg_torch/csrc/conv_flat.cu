// K4: stride-1 k x k "same" convolution on the flat guard-banded layout for
// Hopper (sm_90a), bf16 in / bf16 out, with a fused epilogue; and the
// prologue of its backward, which turns the output's cotangent into what the
// gradients read.
//
// Replaces the Pallas TPU kernel tunevlseg_tpu/ops/conv_pallas.py:
// _conv_flat_pallas. It computes the same function. Activations are
// (B, ROWS, C) with pixel (h, w) of the zero-padded (Hp, Wp) plane at row
// MB + h*Wp + w, so tap (dy, dx) of the convolution is the constant row offset
// (dy-r)*Wp + (dx-r), and
//
//     acc[m, o] = sum_t sum_c x[m + off_t, c] * W[t, c, o]          (f32)
//     out[m, o] = valid(m) ? relu(acc * scale[o] + offset[o] + residual[m, o]) : 0
//
// with the epilogue in f32 in that order, one rounding to bf16, and every row
// written: guard bands and the r-ring of the plane are exact zeros, because
// the next convolution's taps read them.
//
// The TPU kernel walks bands of MB rows in order, fetches halo bands around
// each, and (for C < 128) copies an im2col patch matrix in VMEM so that one
// deep product fills its 128-deep matrix unit. None of that carries over.
// Here the convolution is an implicit GEMM: a block owns a tile of 128 flat
// rows x BN output channels of one image, and its K loop runs over (tap,
// chunk of BK input channels). The A operand of a step is the tile's rows
// shifted by the tap's offset: one TMA box of 128 rows x BK channels at row
// m0 + off of a 3-D tensor map over (B, ROWS, C). A tap offset is not a
// multiple of the 8-row swizzle atom, so one halo window in shared memory
// could not serve all k*k taps through swizzled descriptors: each tap is a box
// of its own, and its rows come from L2 after the first tap read them. Rows
// before 0 or past ROWS (only masked rows ask for them) and channels past C
// are zero-filled by the TMA unit. The B operand is a box of BN x BK of the
// weight, laid out (Cout, k*k, C), at tap t (or k*k-1-t for the input
// gradient, which is this convolution with the weight transposed and its taps
// reversed, so that the same weight copy layout serves both).
//
// Bound: the 3 x 3 convolutions of the RN50 stages do 2*B*H*W*9*C*Cout =
// 51 GFLOP each at b64, 416^2 against < 0.4 GB, far above the card's ridge:
// bound by the tensor cores. The stem (C = 32) and the 1 x 1 convolutions that
// widen to 4 * planes are bound by bytes, most of them the output's.
//
// Design: persistent and warp-specialised. As many blocks as fit on the card
// (two per SM at BN = 64, one at 128 and 256) each take every gridDim.x-th
// tile, first of the tiles that hold no pixel row (guard bands: most of ROWS
// at 13 x 13), which they fill with zeros and load nothing for, then of the
// tiles with pixels. One producer warp keeps a ring of S stages full with TMA
// loads (full / empty mbarrier pairs), running ahead into the block's next
// tile. Two consumer warpgroups each multiply their 64 rows of a stage with
// wgmma m64nBNk16 (A and B K-major in shared memory, 128-byte swizzle for BK =
// 64, 64-byte for BK = 32 when C <= 32), keep one group of products in flight
// and release a stage when its products are done. The epilogue of a tile
// overlaps the loads of the next: each warpgroup asks for its rows' residual
// (16-byte pieces), stages its f32 accumulators in a shared-memory tile of
// its own and then walks its rows 16 bytes a thread (a warp covers whole
// rows): scale, offset, residual, ReLU, mask, one rounding, 16-byte stores.
// The tile order keeps the N-tiles of one row tile side by side, so their
// shared A rows (and the k*k shifted re-reads of them) come from L2.
//
// The backward prologue (dy_prologue_kernel) reads the cotangent g and the
// output (for the ReLU state; without ReLU the row's validity) once and
// writes, as asked: bf16(dy * scale) for the input-gradient launch of K4,
// bf16(dy) for the weight gradient's products and d_residual, and per-block
// f32 sums of dy over rows, which the caller sums over blocks in a fixed
// order (d_offset; no atomics, so deterministic). Bound by bytes.
//
// Limits, checked here and by the wrapper: C and Cout multiples of 8 (16-byte
// rows, TMA strides), k odd with k / 2 <= r, contiguous 16-byte aligned
// tensors.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see tunevlseg_torch/ops/build.py). Plain C entry points,
// loaded with ctypes. The tensor maps are encoded on the host through the
// driver entry point the runtime hands out, so the library links no -lcuda.

#include <algorithm>

#include "attn_common.cuh"
#include "hopper.cuh"

namespace {

using namespace tvs;

constexpr int kBM = 128;                   // rows of a block tile
constexpr int kConsumers = 256;            // two warpgroups of 64 rows each
constexpr int kThreads = kConsumers + 32;  // and one producer warp

struct ConvParams {
  const float* scale;             // (Cout) or null (1)
  const float* offset;            // (Cout) or null (0)
  const __nv_bfloat16* residual;  // (B, rows, Cout) or null
  __nv_bfloat16* out;             // (B, rows, Cout)
  int rows, C, Cout, k, wp, hp, r, mb, relu, flip;
};

// shared memory of one configuration: the ring of S stages (A: 128 x BK,
// B: BN x BK, bf16), the f32 staging tile of the epilogue (128 rows x up to
// 128 channels, rows padded by 8 floats so that the fragment stores are free
// of bank conflicts; BN = 256 goes through it in two passes), the 2 * S
// barriers
template <int BK, int BN, int S>
struct Smem {
  static constexpr int kSwizzle = BK * 2;
  static constexpr int kABytes = kBM * BK * 2;
  static constexpr int kBBytes = BN * BK * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kPass = BN < 128 ? BN : 128;  // channels staged at once
  static constexpr int kStride = kPass + 8;
  static constexpr int kRing = S * kStageBytes;
  static constexpr int kStaging = kBM * kStride * 4;
  static constexpr int kBytes = kRing + kStaging + 2 * S * 8 + 1024;  // + alignment slack
};

// The tiles of one launch: (B images) x (ROWS / 128 row tiles) x (Cout / BN),
// split into those that hold a pixel row (row tiles [m_lo, m_hi]) and those
// that do not, each list in the order (image, row tile, channel tile) with
// the channel tile fastest. Blocks take every gridDim.x-th entry of each list.
struct Tiles {
  int n_tiles, m_tiles, m_lo, m_hi;
  __device__ __forceinline__ int compute_count(int B) const {
    return B * (m_hi - m_lo + 1) * n_tiles;
  }
  __device__ __forceinline__ int zero_count(int B) const {
    return B * (m_tiles - (m_hi - m_lo + 1)) * n_tiles;
  }
  __device__ __forceinline__ void compute(int q, int& n, int& m, int& b) const {
    const int per = m_hi - m_lo + 1;
    n = q % n_tiles;
    m = m_lo + (q / n_tiles) % per;
    b = q / (n_tiles * per);
  }
  __device__ __forceinline__ void zero(int z, int& n, int& m, int& b) const {
    const int per = m_tiles - (m_hi - m_lo + 1);
    n = z % n_tiles;
    const int mz = (z / n_tiles) % per;
    m = mz < m_lo ? mz : mz + (m_hi - m_lo + 1);
    b = z / (n_tiles * per);
  }
};

__device__ __forceinline__ bool pixel_row(int row, int mb, int wp, int hp, int r) {
  const int pp = row - mb;  // index in the padded plane
  if (pp < 0) return false;
  const int hh = pp / wp;
  const int ww = pp - hh * wp;
  return hh >= r && hh < hp - r && ww >= r && ww < wp - r;
}

template <int BK, int BN, int S, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    conv_flat_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w, const ConvParams p,
                     const Tiles tiles, const int B) {
  using L = Smem<BK, BN, S>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* staging = reinterpret_cast<float*>(smem + L::kRing);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kRing + L::kStaging);
  uint64_t* empty = full + S;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int k2 = p.k * p.k;
  const int rk = p.k / 2;
  const int nchunks = (p.C + BK - 1) / BK;
  const int iters = k2 * nchunks;
  const int n_compute = tiles.compute_count(B);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp == kConsumers / 32) {
    // producer: ring position g = (tile, tap, chunk of BK channels) in order
    if (lane == 0) {
      tma_prefetch_map(&tm_x);
      tma_prefetch_map(&tm_w);
      int g = 0;
      for (int q = blockIdx.x; q < n_compute; q += gridDim.x) {
        int nt, mt, b;
        tiles.compute(q, nt, mt, b);
        for (int it = 0; it < iters; ++it, ++g) {
          const int s = g % S;
          mbar_wait(&empty[s], ((g / S) & 1) ^ 1);
          const int tap = it / nchunks;
          const int c0 = (it - tap * nchunks) * BK;
          const int off = (tap / p.k - rk) * p.wp + (tap % p.k - rk);
          mbar_arrive_expect_tx(&full[s], L::kStageBytes);
          tma_load_3d(smem + s * L::kABytes, &tm_x, &full[s], c0, mt * kBM + off, b);
          tma_load_3d(smem + S * L::kABytes + s * L::kBBytes, &tm_w, &full[s], c0,
                      p.flip ? k2 - 1 - tap : tap, nt * BN);
        }
      }
    }
    return;
  }

  // consumers. First the tiles without a pixel row: zeros, no loads (the
  // producer meanwhile fills the ring for the first tile with pixels)
  constexpr int kPieces = BN / 8;  // 16-byte pieces of a tile row
  const int n_zero = tiles.zero_count(B);
  for (int z = blockIdx.x; z < n_zero; z += gridDim.x) {
    int nt, mt, b;
    tiles.zero(z, nt, mt, b);
    const int64_t img = static_cast<int64_t>(b) * p.rows;
    for (int i = threadIdx.x; i < kBM * kPieces; i += kConsumers) {
      const int row = mt * kBM + i / kPieces;
      const int col = nt * BN + (i % kPieces) * 8;
      if (row < p.rows && col < p.Cout)
        *reinterpret_cast<uint4*>(p.out + (img + row) * p.Cout + col) = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // warpgroup wg multiplies rows [64 wg, 64 wg + 64) of each tile, and
  // stages and stores those rows alone
  const int wg = warp / 4;
  const int t = threadIdx.x % 128;
  float* stage = staging + wg * 64 * L::kStride;
  int g = 0;
  for (int q = blockIdx.x; q < n_compute; q += gridDim.x) {
    int nt, mt, b;
    tiles.compute(q, nt, mt, b);
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    fence_operands(acc);
    for (int it = 0; it < iters; ++it, ++g) {
      const int s = g % S;
      mbar_wait(&full[s], (g / S) & 1);
      const uint64_t da = kmajor_desc(smem + s * L::kABytes + wg * (64 * BK * 2), L::kSwizzle);
      const uint64_t db = kmajor_desc(smem + S * L::kABytes + s * L::kBBytes, L::kSwizzle);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)  // 16 channels = 32 bytes = 2 descriptor units
        wgmma_m64k16<BN>(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done: release its stage
      if (it > 0 && lane == 0) mbar_arrive(&empty[(g - 1) % S]);
    }
    wgmma_wait<0>();
    fence_operands(acc);
    if (lane == 0) mbar_arrive(&empty[(g - 1) % S]);

    // epilogue, in passes of kPass channels. A thread owns 8 channels (16
    // bytes of output) of every kRowStep-th row of its warpgroup's 64: it
    // asks for those rows' residual first, so that the loads' latency hides
    // behind the staging; the accumulator fragment goes to the staging tile
    // as it lies; then scale, offset, residual, ReLU, mask, one rounding
    constexpr int kThreadsPerRow = L::kPass / 8;
    constexpr int kRowStep = 128 / kThreadsPerRow;
    constexpr int kRounds = 64 / kRowStep;
    const int m0 = mt * kBM + wg * 64;
    const int64_t img = static_cast<int64_t>(b) * p.rows;
    const int frag_row = (t / 32) * 16 + lane / 4;
    const int lr0 = t / kThreadsPerRow;
    const int lc = (t % kThreadsPerRow) * 8;
    uint32_t pixels = 0;  // bit u: row lr0 + u * kRowStep holds a pixel
#pragma unroll
    for (int u = 0; u < kRounds; ++u) {
      const int row = m0 + lr0 + u * kRowStep;
      if (row < p.rows && pixel_row(row, p.mb, p.wp, p.hp, p.r)) pixels |= 1u << u;
    }
#pragma unroll
    for (int pass = 0; pass < BN / L::kPass; ++pass) {
      const int col = nt * BN + pass * L::kPass + lc;
      const bool col_ok = col < p.Cout;
      uint4 res[kRounds];
#pragma unroll
      for (int u = 0; u < kRounds; ++u) {
        res[u] = make_uint4(0u, 0u, 0u, 0u);
        if (p.residual != nullptr && col_ok && (pixels >> u & 1u))
          res[u] = __ldg(reinterpret_cast<const uint4*>(
              p.residual + (img + m0 + lr0 + u * kRowStep) * p.Cout + col));
      }
      float sc[8], of[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) sc[e] = 1.f, of[e] = 0.f;
      if (p.scale != nullptr && col_ok) {
        const float4 s0 = __ldg(reinterpret_cast<const float4*>(p.scale + col));
        const float4 s1 = __ldg(reinterpret_cast<const float4*>(p.scale + col + 4));
        const float4 o0 = __ldg(reinterpret_cast<const float4*>(p.offset + col));
        const float4 o1 = __ldg(reinterpret_cast<const float4*>(p.offset + col + 4));
        sc[0] = s0.x, sc[1] = s0.y, sc[2] = s0.z, sc[3] = s0.w;
        sc[4] = s1.x, sc[5] = s1.y, sc[6] = s1.z, sc[7] = s1.w;
        of[0] = o0.x, of[1] = o0.y, of[2] = o0.z, of[3] = o0.w;
        of[4] = o1.x, of[5] = o1.y, of[6] = o1.z, of[7] = o1.w;
      }
      named_barrier(2 + wg, 128);  // the last pass's reads of the staging are done
#pragma unroll
      for (int j = 0; j < L::kPass / 8; ++j) {
        const int c = 8 * j + 2 * (lane % 4);
        const int a = (pass * L::kPass) / 8 + j;  // n8 group of the fragment
        *reinterpret_cast<float2*>(stage + frag_row * L::kStride + c) =
            make_float2(acc[4 * a], acc[4 * a + 1]);
        *reinterpret_cast<float2*>(stage + (frag_row + 8) * L::kStride + c) =
            make_float2(acc[4 * a + 2], acc[4 * a + 3]);
      }
      named_barrier(2 + wg, 128);  // this warpgroup's 64 rows are staged
      if (!col_ok) continue;
#pragma unroll
      for (int u = 0; u < kRounds; ++u) {
        const int lr = lr0 + u * kRowStep;
        const int row = m0 + lr;
        if (row >= p.rows) break;
        uint4 packed = make_uint4(0u, 0u, 0u, 0u);
        if (pixels >> u & 1u) {
          float v[8], r8[8];
          const float4 lo = *reinterpret_cast<const float4*>(stage + lr * L::kStride + lc);
          const float4 hi = *reinterpret_cast<const float4*>(stage + lr * L::kStride + lc + 4);
          v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
          v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
          unpack8(res[u], r8);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            v[e] = v[e] * sc[e] + of[e] + r8[e];
            if (p.relu) v[e] = fmaxf(v[e], 0.f);
          }
          packed = pack8(v);
        }
        *reinterpret_cast<uint4*>(p.out + (img + row) * p.Cout + col) = packed;
      }
    }
  }
}

// --- the backward's prologue -------------------------------------------------

struct DyParams {
  const __nv_bfloat16* g;    // (n_rows, Cout): the output's cotangent
  const __nv_bfloat16* out;  // (n_rows, Cout): the output, read for the ReLU state
  const float* scale;        // (Cout), read when dys is written
  __nv_bfloat16* dys;        // bf16(dy * scale) or null
  __nv_bfloat16* dyb;        // bf16(dy) or null
  float* part;               // (gridDim.y, Cout) sums of dy over a block's rows, or null
  int64_t n_rows;            // B * ROWS
  int rows, Cout, wp, hp, r, mb, relu, rows_per_block, tpr;
};

constexpr int kDyThreads = 256;

// dy = g * (relu ? out > 0 : valid(row)), in f32; thread (tx, ty) of a block
// owns channels [8 (blockIdx.x * tpr + tx), + 8) and every rpp-th row of the
// block's rows
__global__ void __launch_bounds__(kDyThreads) dy_prologue_kernel(const DyParams p) {
  __shared__ float red[kDyThreads * 8];
  const int tx = threadIdx.x % p.tpr;
  const int ty = threadIdx.x / p.tpr;
  const int rpp = kDyThreads / p.tpr;
  const int col = (blockIdx.x * p.tpr + tx) * 8;
  const bool col_ok = col < p.Cout;
  float sc[8], sum[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) sum[e] = 0.f;
  if (col_ok && p.dys != nullptr) {
    const float4 s0 = __ldg(reinterpret_cast<const float4*>(p.scale + col));
    const float4 s1 = __ldg(reinterpret_cast<const float4*>(p.scale + col + 4));
    sc[0] = s0.x, sc[1] = s0.y, sc[2] = s0.z, sc[3] = s0.w;
    sc[4] = s1.x, sc[5] = s1.y, sc[6] = s1.z, sc[7] = s1.w;
  }
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * p.rows_per_block;
  const int64_t r1 = min(r0 + p.rows_per_block, p.n_rows);
  for (int64_t row = r0 + ty; col_ok && row < r1; row += rpp) {
    const int64_t at = row * p.Cout + col;
    float dy[8], keep[8];
    unpack8(__ldg(reinterpret_cast<const uint4*>(p.g + at)), dy);
    if (p.relu) {
      float o[8];
      unpack8(__ldg(reinterpret_cast<const uint4*>(p.out + at)), o);
#pragma unroll
      for (int e = 0; e < 8; ++e) keep[e] = o[e] > 0.f ? 1.f : 0.f;
    } else {
      const float v = pixel_row(static_cast<int>(row % p.rows), p.mb, p.wp, p.hp, p.r) ? 1.f : 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) keep[e] = v;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      dy[e] *= keep[e];
      sum[e] += dy[e];
    }
    if (p.dyb != nullptr) *reinterpret_cast<uint4*>(p.dyb + at) = pack8(dy);
    if (p.dys != nullptr) {
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = dy[e] * sc[e];
      *reinterpret_cast<uint4*>(p.dys + at) = pack8(v);
    }
  }
  if (p.part == nullptr) return;
#pragma unroll
  for (int e = 0; e < 8; ++e) red[threadIdx.x * 8 + e] = sum[e];
  __syncthreads();
  if (ty == 0 && col_ok) {
    float total[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) total[e] = 0.f;
    for (int y = 0; y < rpp; ++y)  // a fixed order: the same bits every run
#pragma unroll
      for (int e = 0; e < 8; ++e) total[e] += red[(y * p.tpr + tx) * 8 + e];
    float* dst = p.part + static_cast<int64_t>(blockIdx.y) * p.Cout + col;
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[e] = total[e];
  }
}

// --- host side ------------------------------------------------------------------

// a bf16 tensor of dims (d0, d1, d2), innermost first, contiguous, read in
// boxes of (b0, b1, b2) with a `swizzle`-byte swizzle; zeros outside
bool encode_3d(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1, uint64_t d2,
               uint32_t b0, uint32_t b1, uint32_t b2, int swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};
  const cuuint32_t box[3] = {b0, b1, b2};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BK, int BN, int S, int kMinBlocks>
cudaError_t launch(const void* x, const void* w, const ConvParams& p, int B, cudaStream_t stream) {
  using L = Smem<BK, BN, S>;
  cudaError_t err = make_context_current();
  if (err != cudaSuccess) return err;
  CUtensorMap tm_x, tm_w;
  if (!encode_3d(&tm_x, x, p.C, p.rows, B, BK, kBM, 1, L::kSwizzle) ||
      !encode_3d(&tm_w, w, p.C, p.k * p.k, p.Cout, BK, 1, BN, L::kSwizzle))
    return cudaErrorNotSupported;
  auto kernel = conv_flat_kernel<BK, BN, S, kMinBlocks>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  // persistent: as many blocks as fit on the card at once
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, L::kBytes)) !=
          cudaSuccess)
    return err;
  // row tiles [m_lo, m_hi] hold the pixel rows [mb + lead, mb + hp*wp - 1 - lead]
  const int lead = p.r * p.wp + p.r;
  Tiles tiles;
  tiles.n_tiles = (p.Cout + BN - 1) / BN;
  tiles.m_tiles = (p.rows + kBM - 1) / kBM;
  tiles.m_lo = (p.mb + lead) / kBM;
  tiles.m_hi = (p.mb + p.hp * p.wp - 1 - lead) / kBM;
  const int64_t work = static_cast<int64_t>(B) * tiles.m_tiles * tiles.n_tiles;
  if (work > (int64_t(1) << 31) - 1) return cudaErrorInvalidValue;
  const int blocks = static_cast<int>(std::min<int64_t>(work, int64_t(sms) * std::max(per_sm, 1)));
  kernel<<<blocks, kThreads, L::kBytes, stream>>>(tm_x, tm_w, p, tiles, B);
  return cudaGetLastError();
}

template <int BK>
cudaError_t launch_bk(const void* x, const void* w, const ConvParams& p, int B, int bn,
                      cudaStream_t stream) {
  // stages: two blocks per SM at BN = 64, one at 128 and 256
  if (bn == 64) return launch<BK, 64, BK == 64 ? 3 : 6, 2>(x, w, p, B, stream);
  if (bn == 128) return launch<BK, 128, BK == 64 ? 4 : 6, 1>(x, w, p, B, stream);
  return launch<BK, 256, BK == 64 ? 3 : 4, 1>(x, w, p, B, stream);
}

}  // namespace

// x (B, rows, C), w (Cout, k*k, C) with the taps dy-major, then dx,
// residual (B, rows, Cout) or null, out (B, rows, Cout): bf16, contiguous,
// 16-byte aligned; scale and offset f32 (Cout) or both null (1 and 0).
// (wp, hp, r, mb) are the flat spec's padded width and height, ring radius
// and guard height. flip = 1 pairs the row offset of tap t with the weight's
// tap k*k-1-t (the input gradient). block_n is the tile's width in output
// channels (64, 128 or 256), 0 to choose by Cout. Returns the cudaError_t of
// the launch (cudaErrorNotSupported if a tensor map could not be encoded).
extern "C" int tvs_conv_flat(const void* x, const void* w, const void* scale, const void* offset,
                             const void* residual, void* out, int B, int rows, int C, int Cout,
                             int k, int wp, int hp, int r, int mb, int relu, int flip, int block_n,
                             void* stream) {
  if (C <= 0 || Cout <= 0 || C % 8 != 0 || Cout % 8 != 0 || k % 2 != 1 || k / 2 > r || B <= 0 ||
      rows <= 0 || (scale == nullptr) != (offset == nullptr) ||
      (block_n != 0 && block_n != 64 && block_n != 128 && block_n != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  ConvParams p;
  p.scale = static_cast<const float*>(scale);
  p.offset = static_cast<const float*>(offset);
  p.residual = static_cast<const __nv_bfloat16*>(residual);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.rows = rows;
  p.C = C;
  p.Cout = Cout;
  p.k = k;
  p.wp = wp;
  p.hp = hp;
  p.r = r;
  p.mb = mb;
  p.relu = relu;
  p.flip = flip;
  // 64 channels a tile (two blocks per SM) where the K loop is short (k*k*C
  // <= 256: the 1 x 1s up to C = 256) or Cout is, else as wide as Cout asks,
  // up to 256 (one block per SM), so that fewer tiles re-read the A rows
  // (measured over the RN50's 25 shapes by scripts/torch_conv_flat_bench.py)
  const int bn = block_n != 0 ? block_n
                 : k * k * C <= 256 || Cout <= 64 ? 64
                 : Cout <= 128                     ? 128
                                                   : 256;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C <= 32) return static_cast<int>(launch_bk<32>(x, w, p, B, bn, st));
  return static_cast<int>(launch_bk<64>(x, w, p, B, bn, st));
}

// The backward's prologue over g and out (n_rows = B * rows, Cout), bf16,
// contiguous: writes dys = bf16(dy * scale) and dyb = bf16(dy) where they are
// not null, and part (ceil(n_rows / rows_per_block), Cout) f32, the sums of
// dy over each block of rows_per_block rows, where it is not null. Returns
// the cudaError_t of the launch.
extern "C" int tvs_conv_flat_dy(const void* g, const void* out, const void* scale, void* dys,
                                void* dyb, void* part, long long n_rows, int rows, int Cout, int wp,
                                int hp, int r, int mb, int relu, int rows_per_block, void* stream) {
  if (n_rows <= 0 || rows <= 0 || Cout <= 0 || Cout % 8 != 0 || rows_per_block <= 0 ||
      (relu && out == nullptr) || (dys != nullptr && scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  DyParams p;
  p.g = static_cast<const __nv_bfloat16*>(g);
  p.out = static_cast<const __nv_bfloat16*>(out);
  p.scale = static_cast<const float*>(scale);
  p.dys = static_cast<__nv_bfloat16*>(dys);
  p.dyb = static_cast<__nv_bfloat16*>(dyb);
  p.part = static_cast<float*>(part);
  p.n_rows = n_rows;
  p.rows = rows;
  p.Cout = Cout;
  p.wp = wp;
  p.hp = hp;
  p.r = r;
  p.mb = mb;
  p.relu = relu;
  p.rows_per_block = rows_per_block;
  int tpr = 1;  // threads per row: a power of two up to 32 (8 channels each)
  while (tpr < 32 && tpr * 8 < Cout) tpr *= 2;
  p.tpr = tpr;
  const long long blocks_y = (n_rows + rows_per_block - 1) / rows_per_block;
  if (blocks_y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Cout + 8 * tpr - 1) / (8 * tpr), static_cast<unsigned>(blocks_y));
  dy_prologue_kernel<<<grid, kDyThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
