// Batched dense matrix-vector products for Hopper (sm_90a): the two matvecs
// of the dense solver path, for one matrix (batch 1) or B matrices at once.
//
//   gemv_rows:  y[b, i] = sum_j M[b, i, j] * x[b, j]     (M x,   Core._mv)
//   gemv_cols:  y[b, j] = sum_i M[b, i, j] * u[b, i]     (M' u,  Core._tv)
//
// Replaces the Pallas TPU kernels of tools/gemv_proto.py:
//   _gemv_kernel (:13, launched by pallas_gemv :29) — A in (1, bm, n) blocks,
//       one dot_general at Precision.HIGHEST per block of bm rows;
//   _vpu_kernel  (:100, launched by vpu_gemv :109) — the transposed layout
//       At (B, n, m) in (1, n, bm) blocks, multiplied by x broadcast along
//       the lanes and reduced over the leading axis.
// gemv_cols is _vpu_kernel's function with At := M: it reduces DOWN the
// columns of the stored matrix, so A'y needs no stored transpose of A. The
// TPU kernels needed shapes padded to multiples of their 512-wide blocks;
// these take any rows and cols.
//
// Layout: M (B, rows, cols) contiguous, x (B, cols), u (B, rows), y
// contiguous, all of one element type (float or double).
//
// What bounds them: bytes. A call reads M once, rows*cols*itemsize bytes per
// problem (3.07 GB for the 512 x 1500 x 1000 f32 batch), for 2*rows*cols
// flops: 0.5 flop per byte in f32, far below the card's ridge, so the floor
// is the bytes of M over 3.35 TB/s. Reaching it needs wide loads and many of
// them in flight on every SM.
//
// Design.
//   gemv_rows: one warp per output row, 8 rows per thread block. The lanes
//   walk the row together, each loading 16 bytes (4 floats / 2 doubles) so a
//   warp reads 512 contiguous bytes per step, four steps in flight into four
//   accumulators (the row's tail too, its empty slots adding zeros); the
//   lanes' sums meet by a shuffle tree. x[b] is re-read by every warp and
//   stays in L1/L2.
//   gemv_cols: a thread block owns 32*V adjacent columns (V = elements per
//   16-byte load), lane l the columns l*V .. l*V+V-1, so for every row the
//   warp reads 512 contiguous bytes; the 8 warps take the rows i = g, g+8,
//   ... and their 8 partial sums per column meet in shared memory in a fixed
//   order. A small batch of tall matrices would give too few blocks to fill
//   132 SMs, so the wrapper may cut the rows into `splits` ranges: each
//   block then writes its range's partial sums to a scratch (B, splits,
//   cols) and a second kernel adds the ranges in order.
//   When cols is not a multiple of V, or a pointer is not 16-byte aligned,
//   the same kernels run with V = 1 (4- or 8-byte loads).
// Every sum has a fixed order that depends on the shapes alone — no atomics
// — so a repeated launch is bit-equal. Sums are plain FMAs in the element
// type: no tensor cores, hence no TF32. Offsets are size_t (the f64 batch is
// 6.1 GB). Later work: TMA-fed shared-memory tiles, and a mask that skips the
// problems a batched solve has already finished.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr long long kMaxGrid = 2147483647LL;  // gridDim.x limit

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load_vec(const T* p) {
  return *reinterpret_cast<const Vec<T, V>*>(p);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
gemv_rows_kernel(const T* __restrict__ M, const T* __restrict__ x,
                 T* __restrict__ y, int rows, int cols, int row_tiles) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t b = blockIdx.x / row_tiles;
  const int i = static_cast<int>(blockIdx.x % row_tiles) * kWarps + warp;
  if (i >= rows) return;  // the whole warp leaves together
  const T* row = M + (b * rows + i) * static_cast<size_t>(cols);
  const T* xb = x + b * static_cast<size_t>(cols);
  const int nvec = cols / V;  // V divides cols on this instantiation

  // four loads of the row and of x in flight per lane; past the row's end
  // a slot loads nothing and adds zero products
  T a0 = T(0), a1 = T(0), a2 = T(0), a3 = T(0);
  for (int k = lane; k < nvec; k += 128) {
    Vec<T, V> m[4], xv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int kq = k + 32 * q;
      if (kq < nvec) {
        m[q] = load_vec<T, V>(row + static_cast<size_t>(kq) * V);
        xv[q] = load_vec<T, V>(xb + static_cast<size_t>(kq) * V);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) m[q].v[e] = xv[q].v[e] = T(0);
      }
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      a0 += m[0].v[e] * xv[0].v[e];
      a1 += m[1].v[e] * xv[1].v[e];
      a2 += m[2].v[e] * xv[2].v[e];
      a3 += m[3].v[e] * xv[3].v[e];
    }
  }
  T acc = (a0 + a1) + (a2 + a3);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) y[b * rows + i] = acc;
}

// out is y (B, cols) when splits == 1, else the scratch (B, splits, cols).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
gemv_cols_kernel(const T* __restrict__ M, const T* __restrict__ u,
                 T* __restrict__ out, int rows, int cols, int col_tiles,
                 int splits, int rows_per_split) {
  __shared__ T part[kWarps][32 * V];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned int bid = blockIdx.x;
  const int tile = static_cast<int>(bid % col_tiles);
  bid /= col_tiles;
  const int s = static_cast<int>(bid % splits);
  const size_t b = bid / splits;
  const int j = (tile * 32 + lane) * V;  // first of this thread's V columns
  const int i0 = s * rows_per_split;
  const int i1 = min(rows, i0 + rows_per_split);

  T acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = T(0);
  if (j < cols) {  // V divides cols, so all V columns are inside
    const T* col = M + b * rows * static_cast<size_t>(cols) + j;
    const T* ub = u + b * static_cast<size_t>(rows);
    int i = i0 + warp;
    for (; i + 3 * kWarps < i1; i += 4 * kWarps) {
      const Vec<T, V> m0 = load_vec<T, V>(col + static_cast<size_t>(i) * cols);
      const Vec<T, V> m1 =
          load_vec<T, V>(col + static_cast<size_t>(i + kWarps) * cols);
      const Vec<T, V> m2 =
          load_vec<T, V>(col + static_cast<size_t>(i + 2 * kWarps) * cols);
      const Vec<T, V> m3 =
          load_vec<T, V>(col + static_cast<size_t>(i + 3 * kWarps) * cols);
      const T u0 = ub[i], u1 = ub[i + kWarps], u2 = ub[i + 2 * kWarps],
              u3 = ub[i + 3 * kWarps];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        acc[e] += m0.v[e] * u0;
        acc[e] += m1.v[e] * u1;
        acc[e] += m2.v[e] * u2;
        acc[e] += m3.v[e] * u3;
      }
    }
    for (; i < i1; i += kWarps) {
      const Vec<T, V> m0 = load_vec<T, V>(col + static_cast<size_t>(i) * cols);
      const T u0 = ub[i];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] += m0.v[e] * u0;
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e) part[warp][lane * V + e] = acc[e];
  __syncthreads();
  if (warp == 0 && j < cols) {
    T* dst = out + (b * splits + s) * static_cast<size_t>(cols) + j;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      T sum = part[0][lane * V + e];
#pragma unroll
      for (int q = 1; q < kWarps; ++q) sum += part[q][lane * V + e];
      dst[e] = sum;
    }
  }
}

// y[b, j] = scratch[b, 0, j] + scratch[b, 1, j] + ... in that order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gemv_cols_reduce_kernel(const T* __restrict__ scratch, T* __restrict__ y,
                        size_t total, int cols, int splits) {
  const size_t idx = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x;
  if (idx >= total) return;
  const size_t b = idx / cols;
  const size_t j = idx - b * cols;
  const T* p = scratch + b * splits * static_cast<size_t>(cols) + j;
  T sum = p[0];
  for (int s = 1; s < splits; ++s) sum += p[static_cast<size_t>(s) * cols];
  y[idx] = sum;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
int launch_rows(const void* M, const void* x, void* y, int batch, int rows,
                int cols, void* stream) {
  if (batch < 0 || rows < 0 || cols < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch > 0 && rows > 0) {
    constexpr int VMAX = 16 / static_cast<int>(sizeof(T));
    const int row_tiles = (rows + kWarps - 1) / kWarps;
    const long long grid = static_cast<long long>(batch) * row_tiles;
    if (grid > kMaxGrid) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const T* Mp = static_cast<const T*>(M);
    const T* xp = static_cast<const T*>(x);
    T* yp = static_cast<T*>(y);
    if (cols % VMAX == 0 && aligned16(M) && aligned16(x)) {
      gemv_rows_kernel<T, VMAX><<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
          Mp, xp, yp, rows, cols, row_tiles);
    } else {
      gemv_rows_kernel<T, 1><<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
          Mp, xp, yp, rows, cols, row_tiles);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_cols(const void* M, const void* u, void* y, void* scratch,
                int batch, int rows, int cols, int splits, void* stream) {
  if (batch < 0 || rows < 0 || cols < 0 || splits < 1 ||
      (splits > 1 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch > 0 && cols > 0) {
    constexpr int VMAX = 16 / static_cast<int>(sizeof(T));
    const bool vec = cols % VMAX == 0 && aligned16(M);
    const int V = vec ? VMAX : 1;
    const int col_tiles = (cols + 32 * V - 1) / (32 * V);
    const int rows_per_split = (rows + splits - 1) / splits;
    const long long grid =
        static_cast<long long>(batch) * splits * col_tiles;
    if (grid > kMaxGrid) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const T* Mp = static_cast<const T*>(M);
    const T* up = static_cast<const T*>(u);
    T* out = static_cast<T*>(splits > 1 ? scratch : y);
    if (vec) {
      gemv_cols_kernel<T, VMAX><<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
          Mp, up, out, rows, cols, col_tiles, splits, rows_per_split);
    } else {
      gemv_cols_kernel<T, 1><<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
          Mp, up, out, rows, cols, col_tiles, splits, rows_per_split);
    }
    if (splits > 1) {
      const int err = static_cast<int>(cudaGetLastError());
      if (err != 0) return err;
      const size_t total = static_cast<size_t>(batch) * cols;
      const size_t blocks = (total + kThreads - 1) / kThreads;
      gemv_cols_reduce_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
          static_cast<const T*>(scratch), static_cast<T*>(y), total, cols,
          splits);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes (scs_tpu_torch/ops/_kernels.py).
// The launch goes on the caller's stream and does not synchronise; the
// return value is cudaGetLastError() right after the launch (0 = success).
extern "C" int gemv_rows_f32(const void* M, const void* x, void* y, int batch,
                             int rows, int cols, void* stream) {
  return launch_rows<float>(M, x, y, batch, rows, cols, stream);
}

extern "C" int gemv_rows_f64(const void* M, const void* x, void* y, int batch,
                             int rows, int cols, void* stream) {
  return launch_rows<double>(M, x, y, batch, rows, cols, stream);
}

// scratch: (batch, splits, cols) elements when splits > 1, else unused.
extern "C" int gemv_cols_f32(const void* M, const void* u, void* y,
                             void* scratch, int batch, int rows, int cols,
                             int splits, void* stream) {
  return launch_cols<float>(M, u, y, scratch, batch, rows, cols, splits,
                            stream);
}

extern "C" int gemv_cols_f64(const void* M, const void* u, void* y,
                             void* scratch, int batch, int rows, int cols,
                             int splits, void* stream) {
  return launch_cols<double>(M, u, y, scratch, batch, rows, cols, splits,
                             stream);
}
