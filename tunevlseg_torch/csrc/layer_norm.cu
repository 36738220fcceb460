// N1: LayerNorm over the last axis of a (rows, D) tensor, forward and
// backward, for the port's bfloat16 blocks (`nn/layers.py` LayerNorm through
// `ops/layer_norm.py`).
//
// It replaces no TPU kernel: the JAX package leaves Flax's LayerNorm to XLA,
// which fuses the upcast, the statistics, the affine and the downcast into one
// pass over the row. Without a kernel the port ran that as three passes (an
// f32 copy of x, PyTorch's f32 layer_norm, a cast of y), moving five times
// the bytes; this is the one pass, by hand.
//
// Bound: bytes. The forward reads x once and writes y once (and 8 bytes of
// statistics a row); the backward reads dy and x once and writes dx once.
// Design, for Hopper:
//  * a row lives in registers. `tpr` threads share a row (a power of two, the
//    largest up to a warp that leaves each thread a vector; above D = 1024,
//    tpr / 32 warps), each holding up to kMaxVecs vectors of 8 elements, read
//    and written 16 bytes at a time by neighbouring threads on neighbouring
//    addresses. D % 8 == 0 and D <= kMaxD;
//  * a block of kThreads threads holds kThreads / tpr rows; the forward runs a
//    block per group of rows (at the ViT's 31,040 x 768, 3,880 blocks of
//    eight rows, eight blocks resident an SM);
//  * statistics in f32 from the registers: an exact two-pass mean and biased
//    variance, rstd = rsqrt(var + eps), as F.layer_norm defines them; the
//    affine in f32 as PyTorch writes it, w * (rstd * (x - mean)) + b, and one
//    rounding to the output type (round to nearest even);
//  * the backward: g = dy * w, x^ = (x - mean) * rstd, and
//    dx = rstd * (g - mean(g) - x^ * mean(g * x^)) in f32, rounded once to
//    x's type. dw = sum(dy * x^) and db = sum(dy) over the rows: each block
//    walks a fixed run of row groups, keeps its columns' sums in registers,
//    adds its row slots in slot order through shared memory and writes one
//    partial row; a second kernel adds the partial rows in a fixed order. No
//    atomics: the result depends on the shape and the card's SM count only.
//
// Plain C entry points (ctypes, `ops/build.py`); every launch goes on the
// stream given and is followed by cudaGetLastError. The wrapper allocates
// every output and the partial rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;               // a block: 8 warps
constexpr int kMaxVecs = 4;                 // 8-element vectors a thread holds
constexpr int kMaxThreadsPerRow = 128;      // two rows a block at least
constexpr int kMaxD = kMaxThreadsPerRow * kMaxVecs * 8;   // 4096
constexpr int kSumSlices = 8;               // the partial rows' adder: slices a column

// ---- 8 elements to and from f32 registers -----------------------------------

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// 8 elements kept as loaded (bfloat16: 4 registers), widened at use: the
// backward holds x and dy this way between its two passes over the row
template <typename T>
struct Raw8 {
  uint4 bits;
  __device__ __forceinline__ void load(const T* p) { bits = *reinterpret_cast<const uint4*>(p); }
  __device__ __forceinline__ void zero() { bits = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void widen(float (&v)[8]) const {
    load8(reinterpret_cast<const T*>(&bits), v);
  }
};

// ---- the sum over a row's threads ------------------------------------------

// Every thread of the row ends with the row's sums of v. Up to a warp:
// butterfly shuffles among the row's lanes (a + b == b + a, so every lane
// holds the same bits). Above: each warp's sums through shared memory
// (`red`, N floats a warp), added in warp order. Every thread of the block
// calls it (the branch on tpr is uniform).
template <int N>
__device__ __forceinline__ void row_sum(float (&v)[N], int tpr, float* red) {
  const int width = tpr < 32 ? tpr : 32;
  for (int off = width / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int n = 0; n < N; ++n) v[n] += __shfl_xor_sync(0xffffffffu, v[n], off);
  }
  if (tpr <= 32) return;
  const int warp = threadIdx.x / 32;
  const int per_row = tpr / 32;
  if (threadIdx.x % 32 == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) red[warp * N + n] = v[n];
  }
  __syncthreads();
  const int first = warp / per_row * per_row;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    float s = 0.f;
    for (int w = 0; w < per_row; ++w) s += red[(first + w) * N + n];
    v[n] = s;
  }
  __syncthreads();  // the buffer is free for the next sum
}

// ---- forward ------------------------------------------------------------------

template <typename TI, typename TO, int V>
__global__ void __launch_bounds__(kThreads)
layer_norm_fwd_kernel(const TI* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, TO* __restrict__ y,
                      float* __restrict__ mean_out, float* __restrict__ rstd_out,
                      long long rows, int D, int tpr, float eps) {
  __shared__ float red[kThreads / 32];
  const int t = threadIdx.x & (tpr - 1);
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / tpr) + threadIdx.x / tpr;
  const bool live = row < rows;
  const int nvec = D / 8;
  const TI* xr = x + row * D;

  float v[V][8];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = t + i * tpr;
    if (live && c < nvec) {
      load8(xr + c * 8, v[i]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[i][j] = 0.f;
    }
  }
  float s[1] = {0.f};
#pragma unroll
  for (int i = 0; i < V; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) s[0] += v[i][j];
  }
  row_sum(s, tpr, red);
  const float mean = s[0] / D;
  float q[1] = {0.f};
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (t + i * tpr < nvec) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = v[i][j] - mean;
        q[0] += d * d;
      }
    }
  }
  row_sum(q, tpr, red);
  const float rstd = rsqrtf(q[0] / D + eps);
  if (!live) return;
  if (t == 0 && mean_out != nullptr) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
  TO* yr = y + row * D;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = t + i * tpr;
    if (c < nvec) {
      float wv[8], bv[8], o[8];
      load8(w + c * 8, wv);
      if (b != nullptr) {
        load8(b + c * 8, bv);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = wv[j] * (rstd * (v[i][j] - mean)) + bv[j];
      store8(yr + c * 8, o);
    }
  }
}

// ---- backward -----------------------------------------------------------------

// Block `blockIdx.x` takes the row groups [blockIdx.x * steps, + steps): one
// row of a group a row slot of the block. With `part`, it writes its partial
// row part[blockIdx.x] = (sum dy * x^ over D columns, sum dy over D columns).
template <typename TI, typename TO, int V>
__global__ void __launch_bounds__(kThreads, 2)
layer_norm_bwd_kernel(const TO* __restrict__ dy, const TI* __restrict__ x,
                      const float* __restrict__ mean, const float* __restrict__ rstd,
                      const float* __restrict__ w, TI* __restrict__ dx,
                      float* __restrict__ part, long long rows, int D, int tpr, int steps) {
  __shared__ float red[kThreads / 32 * 2];
  __shared__ float acc[2 * kMaxD];
  const int rpb = kThreads / tpr;
  const int t = threadIdx.x & (tpr - 1);
  const int slot = threadIdx.x / tpr;
  const int nvec = D / 8;
  const float inv_d = 1.f / D;

  float ag[V][8], ab[V][8];
#pragma unroll
  for (int i = 0; i < V; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) ag[i][j] = ab[i][j] = 0.f;
  }

  const long long first = static_cast<long long>(blockIdx.x) * steps * rpb;
  for (int step = 0; step < steps; ++step) {
    const long long row = first + static_cast<long long>(step) * rpb + slot;
    const bool live = row < rows;
    const float m = live ? mean[row] : 0.f;
    const float rs = live ? rstd[row] : 0.f;
    Raw8<TI> xraw[V];
    Raw8<TO> graw[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = t + i * tpr;
      if (live && c < nvec) {
        xraw[i].load(x + row * D + c * 8);
        graw[i].load(dy + row * D + c * 8);
      } else {
        xraw[i].zero();
        graw[i].zero();
      }
    }
    // first pass: the two row sums, and the columns' partial sums
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = t + i * tpr;
      if (c < nvec) {
        float xv[8], gv[8], wv[8];
        xraw[i].widen(xv);
        graw[i].widen(gv);
        load8(w + c * 8, wv);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xh = (xv[j] - m) * rs;
          const float g = gv[j] * wv[j];
          ag[i][j] += gv[j] * xh;
          ab[i][j] += gv[j];
          s[0] += g;
          s[1] += g * xh;
        }
      }
    }
    row_sum(s, tpr, red);
    if (!live || dx == nullptr) continue;
    // second pass: dx, from the row held as loaded
    const float c1 = s[0] * inv_d;
    const float c2 = s[1] * inv_d;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = t + i * tpr;
      if (c < nvec) {
        float xv[8], gv[8], wv[8], o[8];
        xraw[i].widen(xv);
        graw[i].widen(gv);
        load8(w + c * 8, wv);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xh = (xv[j] - m) * rs;
          o[j] = rs * (gv[j] * wv[j] - c1 - xh * c2);
        }
        store8(dx + row * D + c * 8, o);
      }
    }
  }
  if (part == nullptr) return;
  // the block's slots added in slot order
  for (int k = 0; k < rpb; ++k) {
    if (slot == k) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int c = t + i * tpr;
        if (c < nvec) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = c * 8 + j;
            acc[col] = k == 0 ? ag[i][j] : acc[col] + ag[i][j];
            acc[D + col] = k == 0 ? ab[i][j] : acc[D + col] + ab[i][j];
          }
        }
      }
    }
    __syncthreads();
  }
  float* out = part + static_cast<long long>(blockIdx.x) * 2 * D;
  for (int k = threadIdx.x; k < 2 * D; k += kThreads) out[k] = acc[k];
}

// dw[c] and db[c]: the `blocks` partial rows added in a fixed order, 32
// columns a block: slice s adds rows s, s + 8, ... in turn, then the slices
// are added in slice order
__global__ void __launch_bounds__(32 * kSumSlices)
layer_norm_bwd_sum_kernel(const float* __restrict__ part, float* __restrict__ dw,
                          float* __restrict__ db, int blocks, int D) {
  __shared__ float red[kSumSlices][32];
  const int lane = threadIdx.x % 32;
  const int slice = threadIdx.x / 32;
  const int k = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (k < 2 * D) {
    for (int blk = slice; blk < blocks; blk += kSumSlices)
      s += part[static_cast<long long>(blk) * 2 * D + k];
  }
  red[slice][lane] = s;
  __syncthreads();
  if (slice != 0 || k >= 2 * D) return;
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kSumSlices; ++i) total += red[i][lane];
  if (k < D) {
    if (dw != nullptr) dw[k] = total;
  } else if (db != nullptr) {
    db[k - D] = total;
  }
}

// ---- launch -------------------------------------------------------------------

// Threads a row: the largest power of two up to a warp with a vector for each
// thread; then doubled until kMaxVecs vectors a thread hold the row
int threads_per_row(int D) {
  const int nvec = D / 8;
  int tpr = 1;
  while (tpr < 32 && tpr * 2 <= nvec) tpr *= 2;
  while ((nvec + tpr - 1) / tpr > kMaxVecs) tpr *= 2;
  return tpr;
}

struct Shape {
  long long rows;
  int D, tpr, vecs;
};

bool make_shape(long long rows, int D, Shape* s) {
  if (rows <= 0 || D <= 0 || D % 8 != 0 || D > kMaxD) return false;
  s->rows = rows;
  s->D = D;
  s->tpr = threads_per_row(D);
  s->vecs = (D / 8 + s->tpr - 1) / s->tpr;
  return s->tpr <= kMaxThreadsPerRow;
}

template <typename TI, typename TO, int V>
void fwd_launch(const Shape& s, const void* x, const void* w, const void* b, void* y,
                void* mean, void* rstd, float eps, cudaStream_t stream) {
  const long long rpb = kThreads / s.tpr;
  const unsigned grid = static_cast<unsigned>((s.rows + rpb - 1) / rpb);
  layer_norm_fwd_kernel<TI, TO, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const TI*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<TO*>(y), static_cast<float*>(mean), static_cast<float*>(rstd), s.rows, s.D,
      s.tpr, eps);
}

template <typename TI, typename TO, int V>
void bwd_launch(const Shape& s, const void* dy, const void* x, const void* mean,
                const void* rstd, const void* w, void* dx, void* part, int blocks, int steps,
                cudaStream_t stream) {
  layer_norm_bwd_kernel<TI, TO, V><<<blocks, kThreads, 0, stream>>>(
      static_cast<const TO*>(dy), static_cast<const TI*>(x), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const float*>(w), static_cast<TI*>(dx),
      static_cast<float*>(part), s.rows, s.D, s.tpr, steps);
}

struct FwdArgs {
  const void *x, *w, *b;
  void *y, *mean, *rstd;
  float eps;
};

struct BwdArgs {
  const void *dy, *x, *mean, *rstd, *w;
  void *dx, *part;
  int blocks, steps;
};

template <typename TI, typename TO>
void launch_typed(const Shape& s, const FwdArgs* f, const BwdArgs* g, cudaStream_t stream) {
  switch (s.vecs) {
#define N1_CASE(V)                                                                            \
  case V:                                                                                     \
    if (f != nullptr)                                                                         \
      fwd_launch<TI, TO, V>(s, f->x, f->w, f->b, f->y, f->mean, f->rstd, f->eps, stream);    \
    else                                                                                      \
      bwd_launch<TI, TO, V>(s, g->dy, g->x, g->mean, g->rstd, g->w, g->dx, g->part, g->blocks, \
                            g->steps, stream);                                                \
    break;
    N1_CASE(1)
    N1_CASE(2)
    N1_CASE(3)
    N1_CASE(4)
#undef N1_CASE
  }
}

// x, y, dy and dx in bfloat16: the one pair the port's blocks run
using BF16 = __nv_bfloat16;

}  // namespace

// y (rows, D) bf16, mean and rstd (rows,) f32, from x (rows, D) bf16, w (D,)
// f32 and b (D,) f32 or null. mean and rstd both
// null: a call no backward follows, which keeps no statistics. Every pointer
// 16-byte aligned. Returns a cudaError_t.
extern "C" int tvs_layer_norm_fwd(const void* x, const void* w, const void* b, void* y,
                                  void* mean, void* rstd, long long rows, int D, float eps,
                                  void* stream) {
  Shape s;
  if (!make_shape(rows, D, &s) || x == nullptr || w == nullptr || y == nullptr ||
      (mean == nullptr) != (rstd == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs f{x, w, b, y, mean, rstd, eps};
  launch_typed<BF16, BF16>(s, &f, nullptr, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// The forward's gradients for dy (rows, D) bf16: dx (rows, D) bf16, or none
// (dx null); with `part` ((max_blocks, 2, D) f32
// scratch), dw (D,) f32 and db (D,) f32, each where it is non-null. max_blocks bounds
// the blocks that carry partial rows (the wrapper gives two an SM, as many as
// are resident at once); without `part` every row group is a block of its own.
extern "C" int tvs_layer_norm_bwd(const void* dy, const void* x, const void* mean,
                                  const void* rstd, const void* w, void* dx, void* part,
                                  void* dw, void* db, long long rows, int D, int max_blocks,
                                  void* stream) {
  Shape s;
  if (!make_shape(rows, D, &s) || dy == nullptr || x == nullptr || mean == nullptr ||
      rstd == nullptr || w == nullptr ||
      (part != nullptr && ((dw == nullptr && db == nullptr) || max_blocks <= 0)) ||
      (part == nullptr && (dx == nullptr || dw != nullptr || db != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rpb = kThreads / s.tpr;
  const long long groups = (rows + rpb - 1) / rpb;
  const long long steps = part == nullptr ? 1 : (groups + max_blocks - 1) / max_blocks;
  const long long blocks = (groups + steps - 1) / steps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BwdArgs g{dy, x, mean, rstd, w, dx, part, static_cast<int>(blocks),
                  static_cast<int>(steps)};
  launch_typed<BF16, BF16>(s, nullptr, &g, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return static_cast<int>(err);
  layer_norm_bwd_sum_kernel<<<(2 * D + 31) / 32, 32 * kSumSlices, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), static_cast<float*>(db),
      static_cast<int>(blocks), D);
  return static_cast<int>(cudaGetLastError());
}
