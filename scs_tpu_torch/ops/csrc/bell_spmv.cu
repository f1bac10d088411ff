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
// block-column ids; x of x_len elements, read as zero beyond its end (the
// caller does not pad it); y (nbr * bs). Padding slots are all-zero tiles
// pointing at block-column 0 and add zeros. The batched entry points take the
// same arrays with a leading batch axis, each problem with its own cols:
// blocks (B, nbr, width, bs, bs), cols (B, nbr, width), x (B, x_len) with
// x_stride elements between problems, y (B, nbr * bs).
//
// What bounds it: bytes. A call reads the pack once, nbr*width*bs*bs*itemsize
// bytes (108 MB for A of the 30000 x 20000 bench LP in f32, 0.9 GB for the
// eight stacked A packs of the batched bench cell), for 2*nbr*width*bs*bs
// flops: 0.5 flop per byte in f32, far below the card's ridge, so the floor
// is pack bytes / 3.35 TB/s (about 32 us for that single A). Reaching it
// needs every SM busy from the first microsecond to the last, with tens of
// kilobytes of loads in flight on each, whatever the pack's shape.
//
// Design: loads straight into registers, wide enough and many enough.
//   * One thread block of 8 warps per (block-row r, chunk of 32*V output rows
//     i, share of the slots). Lane l of every warp owns the V neighbouring
//     rows i = chunk*32*V + l*V ..., and warp g sums the terms j = g, g+8,
//     g+16, ... of each tile, so for every j the 32 lanes read 32*V
//     consecutive elements of the transposed tile in one load of V elements
//     a lane. The staged slots of a block-row are one run of rows in memory,
//     and the loop over them is unrolled to keep 8 such loads in flight per
//     thread. V is 2 in f32 (8-byte loads) where bs is a multiple of 64, and
//     1 otherwise: f32 then has as many bytes in flight on an SM as f64,
//     which at one 8-byte load a lane and four in flight already ran within
//     10-15% of the memory rate, while f32 at 4 bytes a lane ran at 62%.
//   * x unpadded. The x tiles x[cols[r,w]*bs : +bs] of as many slots as fit
//     in 16 KB are staged in shared memory at once (all slots of the bench
//     packs), each element tested against x_len: the caller passes x at its
//     true length and no padded copy is made.
//   * Work split along the slots where the pack alone does not fill the
//     card. The launcher deals the slots of a block-row to `split` thread
//     blocks (1, 2, 4 or 8) while the grid holds fewer than two blocks per SM.
//     The blocks of one (block-row, chunk) form a thread block cluster: each
//     leaves its sums in its own shared memory, and after a cluster barrier
//     the first adds them through distributed shared memory in rank order and
//     writes y. No atomics and no scratch in device memory: the order of
//     every sum is fixed by the shapes alone, so a repeated launch is
//     bit-equal. With split = 1 (every bench pack but the wide one) no cluster
//     is launched and nothing is exchanged.
//   * The 8 partial sums of each row meet in shared memory in a fixed order.
// A batch is the grid's second axis, blockIdx.y = problem b, which offsets
// blocks, cols, x and y; every offset is a size_t (the batched bench cell's
// f64 pack is 4.6 GB, past any 32-bit byte offset). The single-matrix entry
// points launch the same kernel with a batch of one, so B = 1 is bit-equal to
// them. Sums are in the element type (float or double) with plain FMAs: no
// tensor cores, hence no TF32.
//
// Why not a ring of stages in shared memory filled by bulk copies
// (cp.async.bulk on mbarriers, a producer thread, 8 consumer warps)? Two such
// kernels were built, passed the same tests and were timed against this one
// on the card (PERF.md has the turns). Non-persistent blocks, one per
// block-row, matched this kernel where a block-row per block happened to
// balance the SMs and lost up to 7% where it did not, and dealing a block-row
// to a cluster of 2, 4 or 8 made it slower, not faster. Persistent blocks, each
// with an equal share of all stages and a grid-wide barrier before the
// straddling block-rows' pieces are added, were slower again, in the large
// batched packs too. The pack is read once and never reused, so shared memory
// buys nothing here that full occupancy and the hardware's own handing out of
// many small blocks do not already give.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 32;  // lanes per warp: a chunk is kLanes * V output rows
constexpr int kWarps = 8;   // j-groups per block
constexpr int kThreads = kLanes * kWarps;
constexpr int kStageBytes = 16384;  // x tiles staged per pass
constexpr int kMaxBatch = 65535;    // gridDim.y limit
constexpr int kMaxSplit = 8;        // portable cluster size
constexpr int kBlocksPerSMWanted = 2;  // split the slots below this

template <typename T, int V> struct Lane;  // V neighbouring elements of T
template <typename T> struct Lane<T, 1> {
  T v[1];
};
template <> struct __align__(8) Lane<float, 2> {
  float v[2];
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bell_spmv_kernel(const T* __restrict__ blocks, const int* __restrict__ cols,
                 const T* __restrict__ x, T* __restrict__ y, int nbr,
                 int width, int bs, int x_len, int x_stride,
                 int slots_per_stage, int split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // slots_per_stage * bs
  T* part = xs + slots_per_stage * bs;     // kWarps * kLanes * V partial sums
  T* mine = part + kThreads * V;           // kLanes * V: this block's sums

  const int chunk_rows = kLanes * V;
  const int chunks = (bs + chunk_rows - 1) / chunk_rows;
  const int rank = blockIdx.x % split;  // within the cluster
  const int unit = blockIdx.x / split;
  const int r = unit / chunks;
  const int lane = threadIdx.x % kLanes;
  const int g = threadIdx.x / kLanes;
  const int i = (unit % chunks) * chunk_rows + lane * V;
  const size_t tile = static_cast<size_t>(bs) * bs;
  const size_t b = blockIdx.y;
  const size_t row = b * nbr + r;
  const T* blk = blocks + row * width * tile + i;
  const int* col_r = cols + row * width;
  const T* xb = x + b * static_cast<size_t>(x_stride);
  // this block's share of the slots
  const int w_begin = static_cast<int>(static_cast<long long>(rank) * width / split);
  const int w_end = static_cast<int>(static_cast<long long>(rank + 1) * width / split);

  T acc[V] = {};
  for (int w0 = w_begin; w0 < w_end; w0 += slots_per_stage) {
    const int ns = min(slots_per_stage, w_end - w0);
    __syncthreads();  // every thread is done with the previous stage
    for (int e = threadIdx.x; e < ns * bs; e += kThreads) {
      const int s = e / bs;
      const size_t xi = static_cast<size_t>(col_r[w0 + s]) * bs + (e - s * bs);
      xs[e] = xi < static_cast<size_t>(x_len) ? xb[xi] : T(0);
    }
    __syncthreads();
    if (i < bs) {
      // the staged slots are one run of ns * bs rows k = (slot, j) in memory
      const T* t = blk + static_cast<size_t>(w0) * tile;
#pragma unroll 8
      for (int k = g; k < ns * bs; k += kWarps) {
        const Lane<T, V> a =
            *reinterpret_cast<const Lane<T, V>*>(t + static_cast<size_t>(k) * bs);
#pragma unroll
        for (int q = 0; q < V; ++q) acc[q] += a.v[q] * xs[k];
      }
    }
  }
#pragma unroll
  for (int q = 0; q < V; ++q) part[(g * kLanes + lane) * V + q] = acc[q];
  __syncthreads();
  // the 8 warps' sums in order; then the cluster's, in rank order
  T* y_r = y + row * bs;
  if (g == 0) {
#pragma unroll
    for (int q = 0; q < V; ++q) {
      T sum = part[lane * V + q];
      for (int p = 1; p < kWarps; ++p) sum += part[(p * kLanes + lane) * V + q];
      if (split > 1) {
        mine[lane * V + q] = sum;
      } else if (i < bs) {
        y_r[i + q] = sum;
      }
    }
  }
  if (split > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (rank == 0 && g == 0 && i < bs) {
#pragma unroll
      for (int q = 0; q < V; ++q) {
        T sum = mine[lane * V + q];
        for (int p = 1; p < split; ++p) {
          sum += cluster.map_shared_rank(mine, p)[lane * V + q];
        }
        y_r[i + q] = sum;
      }
    }
    cluster.sync();  // nobody leaves while its sums may still be read
  }
}

template <typename T, int V>
int launch_v(const T* blocks, const int* cols, const T* x, T* y, int batch,
             int nbr, int width, int bs, int x_len, int x_stride,
             cudaStream_t stream) {
  const int per_slot = bs * static_cast<int>(sizeof(T));
  int slots = kStageBytes / per_slot;
  slots = slots < 1 ? 1 : (slots > width ? width : slots);
  const size_t smem =
      (static_cast<size_t>(slots) * bs + kThreads * V + kLanes * V) * sizeof(T);
  const int chunks = (bs + kLanes * V - 1) / (kLanes * V);
  const long long units = static_cast<long long>(nbr) * chunks;
  if (units * kMaxSplit > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);

  // split the slots while the card is short of blocks
  static int sm_count = 0;  // of the first device used; a hint, not a limit
  if (sm_count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      sm_count = 132;
    }
  }
  int split = 1;
  while (split < kMaxSplit && 2 * split <= width &&
         units * batch * split < static_cast<long long>(kBlocksPerSMWanted) * sm_count) {
    split *= 2;
  }

  const dim3 grid(static_cast<unsigned>(units * split), batch);
  if (split == 1) {
    bell_spmv_kernel<T, V><<<grid, kThreads, smem, stream>>>(
        blocks, cols, x, y, nbr, width, bs, x_len, x_stride, slots, split);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc =
      cudaLaunchKernelEx(&cfg, bell_spmv_kernel<T, V>, blocks, cols, x, y, nbr,
                         width, bs, x_len, x_stride, slots, split);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* blocks_, const void* cols_, const void* x_, void* y_,
           int batch, int nbr, int width, int bs, int x_len, int x_stride,
           void* stream_) {
  if (batch < 0 || batch > kMaxBatch || nbr < 0 || width < 1 || bs < 1 ||
      bs > 1024 || x_len < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nbr == 0 || batch == 0) return static_cast<int>(cudaGetLastError());
  const T* blocks = static_cast<const T*>(blocks_);
  const int* cols = static_cast<const int*>(cols_);
  const T* x = static_cast<const T*>(x_);
  T* y = static_cast<T*>(y_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if constexpr (sizeof(T) == 4) {
    // two elements a lane where every lane has two to take and every load
    // is 8-byte aligned: bs a multiple of 64, the pack 8-byte aligned
    if (bs % (2 * kLanes) == 0 && reinterpret_cast<size_t>(blocks_) % 8 == 0) {
      return launch_v<T, 2>(blocks, cols, x, y, batch, nbr, width, bs, x_len,
                            x_stride, stream);
    }
  }
  return launch_v<T, 1>(blocks, cols, x, y, batch, nbr, width, bs, x_len,
                        x_stride, stream);
}

}  // namespace

// Plain C entry points, bound with ctypes (scs_tpu_torch/ops/_kernels.py).
// The launch goes on the caller's stream and does not synchronise; the
// return value is the launch's cudaError (0 = success). x holds x_len
// elements and counts as zero beyond them.
extern "C" int bell_spmv_f32(const void* blocks, const void* cols,
                             const void* x, void* y, int nbr, int width,
                             int bs, int x_len, void* stream) {
  return launch<float>(blocks, cols, x, y, 1, nbr, width, bs, x_len, 0, stream);
}

extern "C" int bell_spmv_f64(const void* blocks, const void* cols,
                             const void* x, void* y, int nbr, int width,
                             int bs, int x_len, void* stream) {
  return launch<double>(blocks, cols, x, y, 1, nbr, width, bs, x_len, 0, stream);
}

// Batched: problem b reads blocks[b], cols[b], x + b * x_stride (x_len
// elements) and writes y[b] (nbr * bs elements).
extern "C" int bell_spmv_batched_f32(const void* blocks, const void* cols,
                                     const void* x, void* y, int batch,
                                     int nbr, int width, int bs, int x_len,
                                     int x_stride, void* stream) {
  return launch<float>(blocks, cols, x, y, batch, nbr, width, bs, x_len,
                       x_stride, stream);
}

extern "C" int bell_spmv_batched_f64(const void* blocks, const void* cols,
                                     const void* x, void* y, int batch,
                                     int nbr, int width, int bs, int x_len,
                                     int x_stride, void* stream) {
  return launch<double>(blocks, cols, x, y, batch, nbr, width, bs, x_len,
                        x_stride, stream);
}
