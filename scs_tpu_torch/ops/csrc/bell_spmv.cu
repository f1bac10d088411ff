// Block-ELL sparse matrix-vector product y = A x for Hopper (sm_90a), for
// one matrix or for a batch of B matrices at once.
//
// Replaces the Pallas TPU kernels of scs_tpu/ops/sparse.py:
//   _bell_kernel_rowmajor (:79) — one grid step per block-row, whole x in VMEM;
//   _bell_kernel          (:59) — one grid step per (block-row, slot), the
//                                 fallback for packs too wide for VMEM;
//   and both under jax.vmap (scs_tpu/batch.py:190, the batched bell path),
//   where Pallas's batching rule adds a batch axis to the grid.
// There are two on the TPU only because of its VMEM budget
// (_BELL_VMEM_BUDGET). On Hopper x stays in device memory and the 50 MB L2,
// so one kernel covers narrow and wide packs alike.
//
// Layout (the packer's, shared with the JAX package so packs are
// interchangeable): blocks (nbr, width, bs, bs) with every tile stored
// TRANSPOSED, blocks[r, w, j, i] = A_tile[i, j]; cols (nbr, width) int32
// block-column ids; x (nbc * bs) zero-padded; y (nbr * bs). Padding slots
// are all-zero tiles pointing at block-column 0 and add zeros. The batched
// entry points take the same arrays with a leading batch axis, each problem
// with its own cols: blocks (B, nbr, width, bs, bs), cols (B, nbr, width),
// x (B, x_len), y (B, nbr * bs), all contiguous.
//
// What bounds it: bytes. A call reads the pack once, nbr*width*bs*bs*itemsize
// bytes (108 MB for A of the 30000 x 20000 bench LP in f32, 0.9 GB for the
// eight stacked A packs of the batched bench cell), for 2*nbr*width*bs*bs
// flops: 0.5 flop per byte in f32, far below the card's ridge, so the floor
// is pack bytes / 3.35 TB/s (about 32 us for that single A). Reaching it
// needs many loads in flight on every SM.
//
// Design: one thread block per (block-row r, chunk of 32 output rows i),
// with 8 warps. Lane l of every warp owns row i = chunk*32 + l; warp g sums
// the terms j = g, g+8, g+16, ... of each tile, so for every j the 32 lanes
// read 32 consecutive elements of the transposed tile (one coalesced 128-byte
// load in f32), and the 8 warps keep 8 rows of the tile in flight. The x
// tiles x[cols[r,w]*bs : +bs] of as many slots as fit in 16 KB are staged in
// shared memory at once (all slots of the bench packs), and the 8 partial
// sums of each row meet in shared memory at the end. The bench A pack gives
// 940 blocks, which fit on the 132 SMs in one wave with ~7 blocks (56
// warps) each. A batch is the grid's second axis, blockIdx.y = problem b,
// which offsets blocks, cols, x and y by b; every offset is a size_t (the
// batched bench cell's f64 pack is 4.6 GB, past any 32-bit byte offset).
// The single-matrix entry points instantiate the kernel without the batch
// offsets and launch the same one-axis grid as before. Sums are in the
// element type (float or double) with plain FMAs: no tensor cores, hence no
// TF32. Later work: tiles streamed through shared memory with TMA, wgmma over
// the B right-hand sides of a batch that shares one pattern, and a mask that
// skips problems a batched solve has already finished.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;  // output rows per block
constexpr int kWarps = 8;   // j-groups per block
constexpr int kThreads = kLanes * kWarps;
constexpr int kStageBytes = 16384;  // x tiles staged per pass
constexpr int kMaxBatch = 65535;    // gridDim.y limit

template <typename T, bool kBatched>
__global__ void __launch_bounds__(kThreads)
bell_spmv_kernel(const T* __restrict__ blocks, const int* __restrict__ cols,
                 const T* __restrict__ x, T* __restrict__ y, int nbr,
                 int width, int bs, int x_len, int slots_per_stage) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);   // slots_per_stage * bs
  T* part = xs + slots_per_stage * bs;      // kWarps * kLanes partial sums

  const int chunks = (bs + kLanes - 1) / kLanes;
  const int r = blockIdx.x / chunks;
  const int lane = threadIdx.x % kLanes;
  const int g = threadIdx.x / kLanes;
  const int i = (blockIdx.x % chunks) * kLanes + lane;
  const size_t tile = static_cast<size_t>(bs) * bs;
  if (kBatched) {
    const size_t b = blockIdx.y;
    const size_t row_slots = static_cast<size_t>(nbr) * width;
    blocks += b * row_slots * tile;
    cols += b * row_slots;
    x += b * static_cast<size_t>(x_len);
    y += b * static_cast<size_t>(nbr) * bs;
  }
  const T* blk = blocks + static_cast<size_t>(r) * width * tile + i;
  const int* col_r = cols + static_cast<size_t>(r) * width;

  T acc = T(0);
  for (int w0 = 0; w0 < width; w0 += slots_per_stage) {
    const int ns = min(slots_per_stage, width - w0);
    __syncthreads();  // every thread is done with the previous stage
    for (int e = threadIdx.x; e < ns * bs; e += kThreads) {
      const int s = e / bs;
      xs[e] = x[static_cast<size_t>(col_r[w0 + s]) * bs + (e - s * bs)];
    }
    __syncthreads();
    if (i < bs) {
      for (int s = 0; s < ns; ++s) {
        const T* t = blk + static_cast<size_t>(w0 + s) * tile;
        const T* xv = xs + s * bs;
#pragma unroll 4
        for (int j = g; j < bs; j += kWarps) {
          acc += t[static_cast<size_t>(j) * bs] * xv[j];
        }
      }
    }
  }
  part[g * kLanes + lane] = acc;
  __syncthreads();
  if (g == 0 && i < bs) {
    T sum = part[lane];
    for (int q = 1; q < kWarps; ++q) sum += part[q * kLanes + lane];
    y[static_cast<size_t>(r) * bs + i] = sum;
  }
}

template <typename T, bool kBatched>
int launch(const void* blocks, const void* cols, const void* x, void* y,
           int batch, int nbr, int width, int bs, int x_len, void* stream) {
  if (batch > kMaxBatch) return static_cast<int>(cudaErrorInvalidValue);
  if (nbr > 0 && batch > 0) {
    const int per_slot = bs * static_cast<int>(sizeof(T));
    int slots = kStageBytes / per_slot;
    slots = slots < 1 ? 1 : (slots > width ? width : slots);
    const size_t smem = (static_cast<size_t>(slots) * bs + kThreads) * sizeof(T);
    const int chunks = (bs + kLanes - 1) / kLanes;
    const dim3 grid(nbr * chunks, batch);
    bell_spmv_kernel<T, kBatched><<<grid, kThreads, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(blocks), static_cast<const int*>(cols),
        static_cast<const T*>(x), static_cast<T*>(y), nbr, width, bs, x_len,
        slots);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes (scs_tpu_torch/ops/_kernels.py).
// The launch goes on the caller's stream and does not synchronise; the
// return value is cudaGetLastError() right after the launch (0 = success).
extern "C" int bell_spmv_f32(const void* blocks, const void* cols,
                             const void* x, void* y, int nbr, int width,
                             int bs, void* stream) {
  return launch<float, false>(blocks, cols, x, y, 1, nbr, width, bs, 0, stream);
}

extern "C" int bell_spmv_f64(const void* blocks, const void* cols,
                             const void* x, void* y, int nbr, int width,
                             int bs, void* stream) {
  return launch<double, false>(blocks, cols, x, y, 1, nbr, width, bs, 0, stream);
}

// Batched: problem b reads blocks[b], cols[b], x[b] (x_len elements each)
// and writes y[b] (nbr * bs elements).
extern "C" int bell_spmv_batched_f32(const void* blocks, const void* cols,
                                     const void* x, void* y, int batch,
                                     int nbr, int width, int bs, int x_len,
                                     void* stream) {
  return launch<float, true>(blocks, cols, x, y, batch, nbr, width, bs, x_len,
                             stream);
}

extern "C" int bell_spmv_batched_f64(const void* blocks, const void* cols,
                                     const void* x, void* y, int batch,
                                     int nbr, int width, int bs, int x_len,
                                     void* stream) {
  return launch<double, true>(blocks, cols, x, y, batch, nbr, width, bs,
                              x_len, stream);
}
