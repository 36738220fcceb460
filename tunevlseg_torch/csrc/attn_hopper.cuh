// Building blocks of the Hopper attention kernels (the forward body of K1 and
// S1, S2, S4 in attn_fwd_hopper.cuh, the S3 forward in
// flash_attn_fwd_variants.cu and the K2 backward in flash_attn_bwd.cu) on top
// of hopper.cuh's generic PTX:
//
//   * host: TMA tensor maps of a (B, S, H, D) bf16 tensor read in place through
//     its strides (a 4-D map over (D, H, S, B), innermost first, boxes of
//     (W, 1, rows, 1) for the column chunks of `Cols<D>`, the swizzle 2 * W
//     bytes: 32 at D = 16, 64 at 32 and at 96 (three chunks of 32), 128 at
//     64; rows past S come back as zeros), and of an f32 row array;
//   * the column chunks of a head-dim-wide tile (`Cols<D>`): the TMA loads of
//     a whole tile, the descriptors of a K-major k16 step and the MN-major
//     product over D;
//   * device: where a thread's values sit in a 64 x N warpgroup accumulator
//     (rows warp * 16 + lane / 4 and + 8 of the warpgroup's 64, columns
//     8 j + 2 (lane % 4) and + 1 of every 8-column group j, the layout of
//     mma.sync's C fragment repeated along N); the repacking of such an f32
//     accumulator into the bf16 A fragments of a register-A wgmma whose K is
//     the accumulator's N (P or dS go straight into the next product and never
//     through shared memory); row max and row sum over the four threads that
//     share a row; and the bf16 store of an accumulator's rows.
#pragma once

#include "attn_common.cuh"
#include "hopper.cuh"

namespace tvs {

// --- column chunks ----------------------------------------------------------------

// A tile row of D bf16 values is one swizzle atom of 2 D bytes at D = 16, 32
// and 64. A row of 96 values (192 bytes) has no TMA swizzle mode, so a
// 96-wide tile is kept as three chunks of 32 columns, one after the other in
// shared memory, each a (rows x 32) tile of its own with the 64-byte swizzle:
// one TMA box a chunk, the k16 steps of a product over D walking the chunks
// (two steps a chunk), and a product whose N is D split into one n32 wgmma a
// chunk (columns 32 c .. 32 c + 31 of a 64 x 96 accumulator are its elements
// 16 c .. 16 c + 15, the layout of a 64 x 32 accumulator). At D <= 64 there is
// one chunk, the whole row, and everything below is what it was without them.
template <int D>
struct Cols {
  static_assert(D == 16 || D == 32 || D == 64 || D == 96, "head dims 16, 32, 64, 96");
  static constexpr int kW = D == 96 ? 32 : D;         // columns of a chunk
  static constexpr int kN = D / kW;                   // chunks
  static constexpr int kSwizzle = 2 * kW;             // bytes of a chunk row
  static constexpr int kSteps = kW / 16;              // k16 steps in a chunk
  static constexpr int kMnStep = (16 * 2 * kW) >> 4;  // an MN-major k16 step, 16-byte units
};

// the chunk width of a head dim on the host (Cols<D>::kW)
inline int chunk_cols(int D) { return D == 96 ? 32 : D; }

// The descriptor of k16 step kk (of D / 16) of a K-major operand whose chunk
// 0 has the descriptor `desc0` (kmajor_desc at Cols<D>::kSwizzle) and whose
// chunks lie `pitch` bytes apart.
template <int D>
__device__ __forceinline__ uint64_t kstep_desc(uint64_t desc0, int pitch, int kk) {
  using C = Cols<D>;
  return desc0 + (kk / C::kSteps) * (pitch >> 4) + 2 * (kk % C::kSteps);
}

// d (64 x D) += A (64 x 16, registers) * B (16 x D): k16 step kk of an
// MN-major operand (read with the transpose bit) whose chunk 0 has the
// descriptor `desc0` (mnmajor_desc at Cols<D>::kSwizzle) and whose chunks lie
// `pitch` bytes apart; one wgmma a chunk, each into its columns of d.
template <int D>
__device__ __forceinline__ void wgmma_rs_cols(float (&d)[D / 2], const uint32_t (&a)[4],
                                              uint64_t desc0, int pitch, int kk) {
  using C = Cols<D>;
#pragma unroll
  for (int c = 0; c < C::kN; ++c)
    wgmma_rs<C::kW, 1>(*reinterpret_cast<float(*)[C::kW / 2]>(&d[c * (C::kW / 2)]), a,
                       desc0 + c * (pitch >> 4) + kk * C::kMnStep);
}

// the chunks of `rows` rows from row `row0` of head h, batch b of a (B, S, H,
// D) map (encode_bshd) into `dst`, chunk c at dst + c * pitch
template <int D>
__device__ __forceinline__ void tma_load_rows(uint8_t* dst, int pitch, const CUtensorMap* map,
                                              uint64_t* bar, int h, int row0, int b) {
  using C = Cols<D>;
#pragma unroll
  for (int c = 0; c < C::kN; ++c) tma_load_4d(dst + c * pitch, map, bar, c * C::kW, h, row0, b);
}

// --- host: tensor maps --------------------------------------------------------------

// (B, S, H, D) bf16 at `base` with (batch, seq, head) strides in elements,
// unit stride on D, read in boxes of `rows` rows and one column chunk
// (chunk_cols(D) columns) of one (batch, head) pair. TMA needs a 16-byte
// aligned base and strides that are multiples of 16 bytes; false if the map
// cannot be encoded.
inline bool encode_bshd(CUtensorMap* map, const void* base, int B, int S, int H, int D,
                        const long long (&strides)[3], int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H), cuuint64_t(S), cuuint64_t(B)};
  const cuuint64_t bytes[3] = {cuuint64_t(strides[2]) * 2, cuuint64_t(strides[1]) * 2,
                               cuuint64_t(strides[0]) * 2};
  const int w = chunk_cols(D);
  const cuuint32_t box[4] = {cuuint32_t(w), 1, cuuint32_t(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, bytes, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_mode(2 * w),
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a contiguous f32 array of dims (d0, d1, d2), innermost first, read in boxes
// of (box0, 1, 1) without a swizzle
inline bool encode_f32_3d(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1,
                          uint64_t d2, uint32_t box0) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t bytes[2] = {d0 * 4, d0 * d1 * 4};
  const cuuint32_t box[3] = {box0, 1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims, bytes, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// --- device: the warpgroup accumulator's layout ---------------------------------

// this thread's place in its warpgroup's 64 x N accumulator
struct AccPlace {
  int row;  // rows `row` and `row + 8` of the warpgroup's 64
  int col;  // columns 8 j + col and + 1
};

__device__ __forceinline__ AccPlace acc_place() {
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid % 32;
  return {((tid / 32) % 4) * 16 + lane / 4, 2 * (lane % 4)};
}

// element i of an accumulator: row `row + 8 * ((i >> 1) & 1)`, column
// 8 * (i >> 2) + col + (i & 1)
__device__ __forceinline__ int acc_row_half(int i) { return (i >> 1) & 1; }
__device__ __forceinline__ int acc_col(int i, int col) { return 8 * (i >> 2) + col + (i & 1); }

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// The bf16 A fragments of a product whose K runs over the N columns of the
// accumulator d (64 x N, N a multiple of 16): k-step kk takes columns
// [16 kk, 16 kk + 16), and its four registers hold (row, cols 8 * 2kk + ...),
// (row + 8, same), (row, cols 8 * (2kk + 1) + ...), (row + 8, same): the A
// layout of wgmma, which is mma.sync's.
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&d)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_f32x2(d[8 * kk + 0], d[8 * kk + 1]);
    a[kk][1] = pack_f32x2(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack_f32x2(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack_f32x2(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// the maximum of each of the thread's two rows over the whole accumulator
template <int R>
__device__ __forceinline__ void acc_row_max(const float (&d)[R], float (&m)[2]) {
  m[0] = m[1] = -INFINITY;
#pragma unroll
  for (int i = 0; i < R; ++i) m[acc_row_half(i)] = fmaxf(m[acc_row_half(i)], d[i]);
  m[0] = group4_max(m[0]);
  m[1] = group4_max(m[1]);
}

// the thread's two rows of a 64 x D accumulator, times f[0] resp. f[1], as
// bf16 at rows `first + place.row` (+ 8) of a (rows x D) slice with
// `row_stride`; rows >= limit are skipped
template <int D>
__device__ __forceinline__ void store_acc_rows(__nv_bfloat16* base, int64_t row_stride,
                                               const float (&d)[D / 2], const float (&f)[2],
                                               int first, int limit, AccPlace place) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = first + place.row + 8 * half;
    if (row >= limit) continue;
    __nv_bfloat16* dst = base + row * row_stride + place.col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_f32x2(d[4 * j + 2 * half] * f[half], d[4 * j + 2 * half + 1] * f[half]);
  }
}

}  // namespace tvs
