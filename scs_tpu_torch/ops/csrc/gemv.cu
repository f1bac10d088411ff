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
// these take any rows and cols, 0 included.
//
// Layout: M (B, rows, cols) contiguous, x (B, cols), u (B, rows), y
// contiguous, all of one element type (float or double), every pointer
// aligned to its element.
//
// What bounds them: bytes. A call reads M once, rows*cols*itemsize bytes per
// problem (3.07 GB for the 512 x 1500 x 1000 f32 batch), for 2*rows*cols
// flops: 0.5 flop per byte in f32, far below the card's ridge, so the floor
// is the bytes of M over 3.35 TB/s. Reaching it needs 16-byte loads and many
// of them in flight on every SM, at every width.
//
// Design.
//   Groups. The columns of a row fall into groups of V = 16 / itemsize
//   (4 floats, 2 doubles): group g is columns V*g .. V*g + V - 1. When cols
//   is no multiple of V, a row starts p elements past a 16-byte boundary,
//   and p changes from row to row. Every load of M is still one aligned
//   16-byte vector: a_k, the k-th aligned vector of the row's span, holds
//   columns V*k - p .. V*k - p + V - 1, so group g is the last V - p
//   elements of a_g and the first p of a_{g+1}. A lane that loaded a_g gets
//   those p elements from its neighbour by shuffles (lane 31 from lane 0's
//   next vector, or from its own extra load) and funnels the group out of
//   the two. Columns past the row's end are selected to zero, never
//   multiplied (they hold the next row's values). An aligned vector that
//   holds one element of M lies in that element's 16-byte granule, so the
//   superset read never leaves M's allocation. There is no narrower load.
//   gemv_rows: a warp per row, 16 rows per block on a large grid (8 on a
//   small one, for more blocks), one problem per block.
//   x[b] is copied into shared memory group-aligned (cp.async, element by
//   element, zero past cols) while the row's first loads are in flight, so
//   its alignment never matters. The row's shift is dispatched once to a
//   loop compiled for it, where the funnel is register renaming. Lane l
//   takes the groups g = l + 32 q + 128 t into slot q; the four vectors of
//   the next pass are loaded while a pass is summed; the slots meet as
//   (a0 + a1) + (a2 + a3) and the lanes by a shuffle tree. Rows of at most
//   8 or 16 groups (the mixed-cone cell's 61 columns) take W = 8 or 16
//   lanes, 4 or 2 rows a warp, one group a lane: the same sums as a whole
//   warp's. Rows over 16 KB funnel x from device memory like M.
//   gemv_cols: a block of 16 warps owns the 32 groups of one column tile
//   (lane l group 32 * tile + l), so for every row a warp reads 512
//   contiguous bytes; warp w takes the rows i0 + w, i0 + w + 16, ... (four
//   in flight) and the warps' partial sums meet in shared memory in warp
//   order. When the grid would have few blocks (one matrix, a few column
//   tiles), the rows are split over a thread block cluster of `cluster`
//   blocks (1-8, the wrapper's cols_cluster): each leaves its sums in its
//   own shared memory, and after a cluster barrier rank 0 adds them through
//   distributed shared memory in rank order. One launch at every shape, no
//   scratch, no atomics.
// Every sum has a fixed order that depends on the shapes (and, for gemv_cols,
// the cluster size, itself a function of the shapes) alone, not on where M
// or x lie: a repeated launch is bit-equal, and so are a 2-D call and B = 1,
// and a misaligned view of M and its aligned copy. Sums are plain FMAs in the
// element type: no tensor cores, hence no TF32. Offsets are size_t (the f64
// batch is 6.1 GB). PERF.md has the designs timed against this one.
//
// D1, the compensated products (gemv_rows_comp_f32, gemv_cols_comp_f32): the
// same two kernels with COMP = true, float only. They replace no Pallas
// kernel: scs_tpu computes them as XLA code (scs_tpu/ops/df32.py:45-60,
// mv and tv; dot is mv on a (B, 1, k) view), where the plain PyTorch form
// materializes the product, its error and four split temporaries the size
// of M. Here M is read once, as by G1/G2, so the bound is the same bytes;
// the extra operations (about ten per element) stay far below the card's
// rate. Each accumulator s has a companion c: a product adds p = fl(a*b) to
// s and its exact error fma(a, b, -p) (Dekker's err, without the split) to
// c, and the addition s + p is itself made error-free (TwoSum), its error
// also going to c; two partial sums meet by the same rule, and the result is
// s + c. So the p-stream's own summation error is compensated as well
// (Ogita-Rump-Oishi Dot2): the result is the product as if summed in twice
// the working precision, whatever the length of a lane's sequential sum
// (gemv_cols runs one down 1500 rows), where scs_tpu relies on XLA's tree
// sums for it. Every step of the compensated path is an _rn intrinsic, which
// nvcc never contracts: a contracted s + a*b would make p something other
// than fl(a*b) and count the rounding twice. COMP = false compiles the plain
// kernels as they were.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr long long kBigGrid = 528;           // gemv_rows: 16-row blocks from 4 per SM up
constexpr int kColsWarps = 16;                // gemv_cols: warps per block
constexpr int kMaxCluster = 8;                // portable cluster size
constexpr long long kMaxGrid = 2147483647LL;  // gridDim.x limit
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
constexpr int kV = 16 / static_cast<int>(sizeof(T));  // elements per 16 bytes

template <typename T>
struct alignas(16) Vec {
  T v[kV<T>];
};

template <typename T>
__device__ __forceinline__ Vec<T> zero_vec() {
  Vec<T> r;
#pragma unroll
  for (int e = 0; e < kV<T>; ++e) r.v[e] = T(0);
  return r;
}

// The aligned vector at p if `ok`, else zeros (no load).
template <typename T>
__device__ __forceinline__ Vec<T> load_if(bool ok, const T* p) {
  Vec<T> r = zero_vec<T>();
  if (ok) r = *reinterpret_cast<const Vec<T>*>(p);
  return r;
}

// The number of elements by which `row` starts past a 16-byte boundary.
template <typename T>
__device__ __forceinline__ int shift_of(const T* row) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(row) / sizeof(T)) & (kV<T> - 1));
}

// Elements P .. V-1 of a, then 0 .. P-1 of b.
template <typename T, int P>
__device__ __forceinline__ void shift(Vec<T>& r, const Vec<T>& a, const Vec<T>& b) {
#pragma unroll
  for (int e = 0; e < kV<T>; ++e) r.v[e] = e + P < kV<T> ? a.v[e + P] : b.v[e + P - kV<T>];
}

// The group out of a (this lane's aligned vector) and b (the next one) for
// a row p elements past a 16-byte boundary, p known at run time.
template <typename T>
__device__ __forceinline__ Vec<T> funnel(const Vec<T>& a, const Vec<T>& b, int p) {
  Vec<T> r = a;
  if constexpr (kV<T> == 4) {
    if (p == 1) shift<T, 1>(r, a, b);
    if (p == 2) shift<T, 2>(r, a, b);
    if (p == 3) shift<T, 3>(r, a, b);
  } else {
    if (p == 1) shift<T, 1>(r, a, b);
  }
  return r;
}

// The vector of lane + 1 within segments of `width` lanes; the first lane
// of a segment offers `wrap` to the last one instead of `own`.
template <typename T>
__device__ __forceinline__ Vec<T> from_next(const Vec<T>& own, const Vec<T>& wrap,
                                            int seg_lane, int width) {
  Vec<T> r;
#pragma unroll
  for (int e = 0; e < kV<T>; ++e) {
    r.v[e] = __shfl_sync(kFull, seg_lane == 0 ? wrap.v[e] : own.v[e], seg_lane + 1, width);
  }
  return r;
}

// The group a lane holds of a row (or of x) that starts p elements past a
// 16-byte boundary: its aligned vector `own` funnelled with the next one,
// which lane + 1 holds; the segment's last lane takes `extra` (its own load)
// if `last_extra`, else what the segment's first lane offers (`succ`). p is
// uniform over a segment of W lanes; every lane of the warp takes part.
template <typename T, int W>
__device__ __forceinline__ Vec<T> group_of(const Vec<T>& own, const Vec<T>& succ,
                                           const Vec<T>& extra, bool last_extra, int p,
                                           int seg_lane) {
  if constexpr (W == 32) {
    if (!p) return own;  // warp-uniform: the shuffles may be skipped
  }
  const Vec<T> nxt = from_next(own, succ, seg_lane, W);
  const bool take = seg_lane == W - 1 && last_extra;
  Vec<T> b;
#pragma unroll
  for (int e = 0; e < kV<T>; ++e) b.v[e] = take ? extra.v[e] : nxt.v[e];
  return funnel(own, b, p);
}

// Valid elements of group g (columns V*g .. V*g + V - 1 below cols).
template <typename T>
__device__ __forceinline__ int valid_in(long long g, int cols) {
  const long long n = cols - static_cast<long long>(kV<T>) * g;
  return n < 0 ? 0 : (n > kV<T> ? kV<T> : static_cast<int>(n));
}

// ------------------------------------------------ compensated accumulation

// s + p as t + e exactly (TwoSum): s := t, and the error e goes to c.
__device__ __forceinline__ void two_sum_add(float& s, float& c, float p) {
  const float t = __fadd_rn(s, p);
  const float bp = __fsub_rn(t, s);
  const float e = __fadd_rn(__fsub_rn(s, __fsub_rn(t, bp)), __fsub_rn(p, bp));
  s = t;
  c = __fadd_rn(c, e);
}

// (s, c) += a * b: the plain FMA, or under COMP p = fl(a*b) into s by TwoSum
// and the product's exact error into c.
template <bool COMP, typename T>
__device__ __forceinline__ void mac(T& s, T& c, T a, T b) {
  if constexpr (COMP) {
    const float p = __fmul_rn(a, b);
    c = __fadd_rn(c, __fmaf_rn(a, b, -p));
    two_sum_add(s, c, p);
  } else {
    s += a * b;
  }
}

// (s, c) += (s2, c2): one partial sum into another.
template <bool COMP, typename T>
__device__ __forceinline__ void merge(T& s, T& c, T s2, T c2) {
  if constexpr (COMP) {
    two_sum_add(s, c, s2);
    c = __fadd_rn(c, c2);
  } else {
    s += s2;
  }
}

// The value of an accumulator: s, or s + c.
template <bool COMP, typename T>
__device__ __forceinline__ T total(T s, T c) {
  if constexpr (COMP) {
    return __fadd_rn(s, c);
  } else {
    return s;
  }
}

// The lanes' sums of a segment of W lanes into every lane (a xor tree).
template <bool COMP, int W, typename T>
__device__ __forceinline__ void reduce_lanes(T& s, T& c) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) {
    if constexpr (COMP) {
      const T s2 = __shfl_xor_sync(kFull, s, off, W);
      const T c2 = __shfl_xor_sync(kFull, c, off, W);
      merge<COMP>(s, c, s2, c2);
    } else {
      s += __shfl_xor_sync(kFull, s, off, W);
    }
  }
}

// ---------------------------------------------------------------- gemv_rows

constexpr int kStageGroups = 1024;  // x staged in shared memory up to 16 KB a row

// Elements P .. V-1 of a and 0 .. P-1 of b, for a shift known at compile time.
template <typename T, int P>
__device__ __forceinline__ Vec<T> funnel_c(const Vec<T>& a, const Vec<T>& b) {
  if constexpr (P == 0) {
    return a;
  } else {
    Vec<T> r;
    shift<T, P>(r, a, b);
    return r;
  }
}

// The group of slot q out of the lane's aligned vectors m[] of a row P
// elements past a 16-byte boundary: elements P.. of its own vector and the
// first P of lane + 1's (lane 31: lane 0's next slot, or `extra` for the
// last slot). Only the P elements needed are shuffled.
template <typename T, int P, int Q>
__device__ __forceinline__ Vec<T> group_c(const Vec<T> (&m)[4], const Vec<T>& extra, int lane) {
  if constexpr (P == 0) {
    return m[Q];
  } else {
    Vec<T> b = m[Q];
#pragma unroll
    for (int e = 0; e < P; ++e) {
      const T offered = Q < 3 && lane == 0 ? m[Q < 3 ? Q + 1 : Q].v[e] : m[Q].v[e];
      const T got = __shfl_sync(kFull, offered, (lane + 1) & 31);
      b.v[e] = Q == 3 && lane == 31 ? extra.v[e] : got;
    }
    return funnel_c<T, P>(m[Q], b);
  }
}

// acc[Q] += the products of slot Q's group g with x (staged in xs), for a
// whole pass (no group of it reaches the row's end) or with the columns
// past cols selected to zero (M holds the next row's values there; xs is
// zero past cols and is not read past its groups).
template <typename T, int P, int Q, bool COMP>
__device__ __forceinline__ void fma_slot(T (&acc)[4], T (&cmp)[4], const Vec<T> (&m)[4],
                                         const Vec<T>& extra, const Vec<T>* xs, long long g,
                                         long long groups, int cols, bool whole, int lane) {
  const Vec<T> gm = group_c<T, P, Q>(m, extra, lane);
  if (whole) {
    const Vec<T> xv = xs[g];
#pragma unroll
    for (int e = 0; e < kV<T>; ++e) mac<COMP>(acc[Q], cmp[Q], gm.v[e], xv.v[e]);
  } else {
    Vec<T> xv = xs[g < groups ? g : 0];
    if (g >= groups) xv = zero_vec<T>();
    const int nv = valid_in<T>(g, cols);
#pragma unroll
    for (int e = 0; e < kV<T>; ++e) mac<COMP>(acc[Q], cmp[Q], e < nv ? gm.v[e] : T(0), xv.v[e]);
  }
}

// The four slots' sums as (a0 + a1) + (a2 + a3), into s and c.
template <bool COMP, typename T>
__device__ __forceinline__ void slots_sum(T (&acc)[4], T (&cmp)[4], T& s, T& c) {
  merge<COMP>(acc[0], cmp[0], acc[1], cmp[1]);
  merge<COMP>(acc[2], cmp[2], acc[3], cmp[3]);
  merge<COMP>(acc[0], cmp[0], acc[2], cmp[2]);
  s = acc[0];
  c = cmp[0];
}

// One row of at most kStageGroups groups, P elements past a 16-byte
// boundary (am: its aligned start), against x staged in xs: lane l, slot q
// takes the groups g = l + 32 q + 128 t. The pass's four aligned vectors
// (cur, the first pass preloaded by the caller) are summed while the next
// pass's are in flight.
template <typename T, int P, bool COMP>
__device__ __forceinline__ void row_staged(const T* am, const Vec<T>* xs, Vec<T> (&cur)[4],
                                           long long groups, int cols, int lane, T& s, T& c) {
  constexpr int V = kV<T>;
  T acc[4] = {T(0), T(0), T(0), T(0)};
  T cmp[4] = {T(0), T(0), T(0), T(0)};
  for (long long k0 = 0; k0 < groups; k0 += 128) {
    const long long k = k0 + lane;
    Vec<T> nxt[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long g = k + 128 + 32 * q;
      nxt[q] = load_if(V * g - P < cols, am + V * g);
    }
    const Vec<T> extra = load_if(P && lane == 31 && V * (k + 97) - P < cols, am + V * (k + 97));
    const bool whole = V * (k0 + 129) <= cols;  // warp-uniform
    fma_slot<T, P, 0, COMP>(acc, cmp, cur, extra, xs, k, groups, cols, whole, lane);
    fma_slot<T, P, 1, COMP>(acc, cmp, cur, extra, xs, k + 32, groups, cols, whole, lane);
    fma_slot<T, P, 2, COMP>(acc, cmp, cur, extra, xs, k + 64, groups, cols, whole, lane);
    fma_slot<T, P, 3, COMP>(acc, cmp, cur, extra, xs, k + 96, groups, cols, whole, lane);
#pragma unroll
    for (int q = 0; q < 4; ++q) cur[q] = nxt[q];
  }
  slots_sum<COMP>(acc, cmp, s, c);
}

// A row of any width with x funnelled from device memory like M (rows past
// the staging size): all shifts at run time.
template <typename T, bool COMP>
__device__ __forceinline__ void row_any(const T* am, int pm, const T* ax, int px,
                                        long long groups, int cols, int lane, T& s, T& c) {
  constexpr int V = kV<T>;
  T acc[4] = {T(0), T(0), T(0), T(0)};
  T cmp[4] = {T(0), T(0), T(0), T(0)};
  for (long long k = lane; k - lane < groups; k += 128) {
    Vec<T> m[4], xv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long g = k + 32 * q;
      m[q] = load_if(V * g - pm < cols, am + V * g);
      xv[q] = load_if(V * g - px < cols, ax + V * g);
    }
    const long long gs = k + 97;  // lane 31's successor of slot 3
    const Vec<T> m_extra = load_if(lane == 31 && pm && V * gs - pm < cols, am + V * gs);
    const Vec<T> x_extra = load_if(lane == 31 && px && V * gs - px < cols, ax + V * gs);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int qn = q < 3 ? q + 1 : q;
      const Vec<T> gm = group_of<T, 32>(m[q], m[qn], m_extra, q == 3, pm, lane);
      const Vec<T> gx = group_of<T, 32>(xv[q], xv[qn], x_extra, q == 3, px, lane);
      const int nv = valid_in<T>(k + 32 * q, cols);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        mac<COMP>(acc[q], cmp[q], e < nv ? gm.v[e] : T(0), e < nv ? gx.v[e] : T(0));
      }
    }
  }
  slots_sum<COMP>(acc, cmp, s, c);
}

__device__ __forceinline__ void cp_async_elem(void* dst, const void* src, int bytes, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 8 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 4 : 0));
  }
}

// W lanes per row, 32 / W rows per warp. W = 32 walks any width, four
// groups in flight per lane (and four more being loaded); W < 32 is for
// rows of at most W groups (one group a lane), where it gives the same sums
// as W = 32 would (the lanes and slots that would hold the missing groups
// add only zeros). COMP: the compensated sums (D1), float only, held to
// four blocks an SM (64 registers; a few bytes spill, and the 32 warps an SM
// beat 93 registers at 16 warps by 16%, in turns on the card).
template <typename T, int W, int WARPS, bool COMP>
__global__ void __launch_bounds__(32 * WARPS, WARPS == 16 ? 2 : (COMP ? 4 : 1))
gemv_rows_kernel(const T* __restrict__ M, const T* __restrict__ x,
                 T* __restrict__ y, int rows, int cols, int row_tiles) {
  static_assert(!COMP || sizeof(T) == 4, "the compensated products are float only");
  constexpr int V = kV<T>;
  const int lane = threadIdx.x & (W - 1);  // within the row's segment
  const size_t b = blockIdx.x / row_tiles;
  const int i = static_cast<int>(blockIdx.x % row_tiles) * (WARPS * (32 / W)) +
                static_cast<int>(threadIdx.x) / W;
  const bool live = i < rows;
  const T* row = M + (b * rows + (live ? i : 0)) * static_cast<size_t>(cols);
  const T* xr = x + b * static_cast<size_t>(cols);
  const int pm = shift_of(row), px = shift_of(xr);  // uniform over the segment
  const T* am = row - pm;  // aligned vector k holds columns V*k - pm ...
  const T* ax = xr - px;
  const long long groups = (cols + V - 1) / V;

  if constexpr (W == 32) {
    T sum, cmp = T(0);
    if (groups <= kStageGroups) {
      // x[b] into shared memory, group-aligned and zero past cols, by
      // element copies issued before the row's first loads and awaited after
      __shared__ Vec<T> xs[kStageGroups];
      T* flat = reinterpret_cast<T*>(xs);
      for (int e = threadIdx.x; e < groups * V; e += 32 * WARPS) {
        cp_async_elem(flat + e, e < cols ? xr + e : xr, sizeof(T), e < cols);
      }
      asm volatile("cp.async.commit_group;\n" ::);
      Vec<T> cur[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const long long g = lane + 32 * q;
        cur[q] = load_if(live && V * g - pm < cols, am + V * g);
      }
      asm volatile("cp.async.wait_all;\n" ::);
      __syncthreads();
      if (!live) return;  // the whole warp leaves together
      switch (pm) {
        case 1: row_staged<T, 1, COMP>(am, xs, cur, groups, cols, lane, sum, cmp); break;
        case 2: row_staged<T, 2 % V, COMP>(am, xs, cur, groups, cols, lane, sum, cmp); break;
        case 3: row_staged<T, 3 % V, COMP>(am, xs, cur, groups, cols, lane, sum, cmp); break;
        default: row_staged<T, 0, COMP>(am, xs, cur, groups, cols, lane, sum, cmp);
      }
    } else {
      if (!live) return;
      row_any<T, COMP>(am, pm, ax, px, groups, cols, lane, sum, cmp);
    }
    reduce_lanes<COMP, 32>(sum, cmp);
    if (lane == 0) y[b * rows + i] = total<COMP>(sum, cmp);
  } else {
    // one group a lane: g = lane < W, all shifts at run time
    const long long g = lane;
    const Vec<T> m = load_if(live && V * g - pm < cols, am + V * g);
    const Vec<T> xv = load_if(V * g - px < cols, ax + V * g);
    const bool last = lane == W - 1;
    const Vec<T> m_extra = load_if(last && live && pm && V * (g + 1) - pm < cols, am + V * (g + 1));
    const Vec<T> x_extra = load_if(last && px && V * (g + 1) - px < cols, ax + V * (g + 1));
    const Vec<T> gm = group_of<T, W>(m, m, m_extra, true, pm, lane);
    const Vec<T> gx = group_of<T, W>(xv, xv, x_extra, true, px, lane);
    const int nv = valid_in<T>(g, cols);
    T sum = T(0), cmp = T(0);
#pragma unroll
    for (int e = 0; e < V; ++e) mac<COMP>(sum, cmp, e < nv ? gm.v[e] : T(0), e < nv ? gx.v[e] : T(0));
    reduce_lanes<COMP, W>(sum, cmp);
    if (lane == 0 && live) y[b * rows + i] = total<COMP>(sum, cmp);
  }
}

// ---------------------------------------------------------------- gemv_cols

// One row's products into acc: the group of the lane (g, nv valid
// elements) out of its aligned vector `own` and lane 31's `extra`, times u.
template <typename T, bool COMP>
__device__ __forceinline__ void add_row(Vec<T>& acc, Vec<T>& cmp, const Vec<T>& own,
                                        const Vec<T>& extra, int p, T u, int nv, int lane) {
  Vec<T> grp = own;
  if (p) {  // warp-uniform
    Vec<T> b;
#pragma unroll
    for (int e = 0; e < kV<T>; ++e) {
      const T nxt = __shfl_down_sync(kFull, own.v[e], 1);
      b.v[e] = lane == 31 ? extra.v[e] : nxt;
    }
    grp = funnel(own, b, p);
  }
#pragma unroll
  for (int e = 0; e < kV<T>; ++e) mac<COMP>(acc.v[e], cmp.v[e], e < nv ? grp.v[e] : T(0), u);
}

// COMP: the compensated sums (D1), float only; the companions of the
// warps' and the cluster's partial sums travel beside them.
template <typename T, bool COMP>
__global__ void __launch_bounds__(32 * kColsWarps)
gemv_cols_kernel(const T* __restrict__ M, const T* __restrict__ u,
                 T* __restrict__ y, int rows, int cols, int col_tiles, int cluster) {
  static_assert(!COMP || sizeof(T) == 4, "the compensated products are float only");
  constexpr int V = kV<T>;
  constexpr int kW = kColsWarps;
  __shared__ Vec<T> part[kW][32];
  __shared__ Vec<T> mine[32];
  __shared__ Vec<T> part_c[COMP ? kW : 1][32];
  __shared__ Vec<T> mine_c[COMP ? 32 : 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rank = static_cast<int>(blockIdx.x % cluster);
  const unsigned unit = blockIdx.x / cluster;
  const int tile = static_cast<int>(unit % col_tiles);
  const size_t b = unit / col_tiles;
  const long long g = static_cast<long long>(tile) * 32 + lane;  // this lane's group
  const int nv = valid_in<T>(g, cols);
  const int i0 = static_cast<int>(static_cast<long long>(rank) * rows / cluster);
  const int i1 = static_cast<int>(static_cast<long long>(rank + 1) * rows / cluster);
  const T* Mb = M + b * rows * static_cast<size_t>(cols);
  const T* ub = u + b * static_cast<size_t>(rows);
  const size_t step = static_cast<size_t>(kW) * cols;
  const bool last = lane == 31;

  // rows i0 + w, i0 + w + kW, ... in order, four in flight
  Vec<T> acc = zero_vec<T>();
  Vec<T> cmp = zero_vec<T>();
  int i = i0 + warp;
  for (; i + 3 * kW < i1; i += 4 * kW) {
    const T* r0 = Mb + static_cast<size_t>(i) * cols;
    const T* r1 = r0 + step;
    const T* r2 = r1 + step;
    const T* r3 = r2 + step;
    const int p0 = shift_of(r0), p1 = shift_of(r1), p2 = shift_of(r2), p3 = shift_of(r3);
    const Vec<T> m0 = load_if(V * g - p0 < cols, r0 - p0 + V * g);
    const Vec<T> m1 = load_if(V * g - p1 < cols, r1 - p1 + V * g);
    const Vec<T> m2 = load_if(V * g - p2 < cols, r2 - p2 + V * g);
    const Vec<T> m3 = load_if(V * g - p3 < cols, r3 - p3 + V * g);
    const Vec<T> e0 = load_if(last && p0 && V * (g + 1) - p0 < cols, r0 - p0 + V * (g + 1));
    const Vec<T> e1 = load_if(last && p1 && V * (g + 1) - p1 < cols, r1 - p1 + V * (g + 1));
    const Vec<T> e2 = load_if(last && p2 && V * (g + 1) - p2 < cols, r2 - p2 + V * (g + 1));
    const Vec<T> e3 = load_if(last && p3 && V * (g + 1) - p3 < cols, r3 - p3 + V * (g + 1));
    const T u0 = ub[i], u1 = ub[i + kW], u2 = ub[i + 2 * kW], u3 = ub[i + 3 * kW];
    add_row<T, COMP>(acc, cmp, m0, e0, p0, u0, nv, lane);
    add_row<T, COMP>(acc, cmp, m1, e1, p1, u1, nv, lane);
    add_row<T, COMP>(acc, cmp, m2, e2, p2, u2, nv, lane);
    add_row<T, COMP>(acc, cmp, m3, e3, p3, u3, nv, lane);
  }
  for (; i < i1; i += kW) {
    const T* r0 = Mb + static_cast<size_t>(i) * cols;
    const int p0 = shift_of(r0);
    const Vec<T> m0 = load_if(V * g - p0 < cols, r0 - p0 + V * g);
    const Vec<T> e0 = load_if(last && p0 && V * (g + 1) - p0 < cols, r0 - p0 + V * (g + 1));
    add_row<T, COMP>(acc, cmp, m0, e0, p0, ub[i], nv, lane);
  }
  part[warp][lane] = acc;
  if constexpr (COMP) part_c[warp][lane] = cmp;
  __syncthreads();
  // the warps' sums in order; then the cluster's, in rank order
  if (warp == 0) {
#pragma unroll 1
    for (int w = 1; w < kW; ++w) {
      const Vec<T> other = part[w][lane];
      Vec<T> other_c = zero_vec<T>();  // no ternary of 16-byte structs: it goes to the stack
      if constexpr (COMP) other_c = part_c[w][lane];
#pragma unroll
      for (int e = 0; e < V; ++e) merge<COMP>(acc.v[e], cmp.v[e], other.v[e], other_c.v[e]);
    }
    mine[lane] = acc;
    if constexpr (COMP) mine_c[lane] = cmp;
  }
  if (cluster > 1) {
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    if (rank == 0 && warp == 0) {
      for (int r = 1; r < cluster; ++r) {
        const Vec<T> other = cl.map_shared_rank(mine, r)[lane];
        Vec<T> other_c = zero_vec<T>();
        if constexpr (COMP) other_c = cl.map_shared_rank(mine_c, r)[lane];
#pragma unroll
        for (int e = 0; e < V; ++e) merge<COMP>(acc.v[e], cmp.v[e], other.v[e], other_c.v[e]);
      }
    }
    cl.sync();  // nobody leaves while its sums may still be read
  }
  if (rank == 0 && warp == 0) {
    T* yb = y + b * static_cast<size_t>(cols) + V * g;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if (e < nv) yb[e] = total<COMP>(acc.v[e], cmp.v[e]);
    }
  }
}

// ------------------------------------------------------------------ launchers

inline bool aligned_to(const void* p, size_t n) {
  return (reinterpret_cast<uintptr_t>(p) % n) == 0;
}

template <typename T, int W, int WARPS, bool COMP>
int launch_rows_w(const T* M, const T* x, T* y, int batch, int rows, int cols,
                  cudaStream_t stream) {
  constexpr int kRowsPerBlock = WARPS * (32 / W);
  const int row_tiles = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long grid = static_cast<long long>(batch) * row_tiles;
  if (grid > kMaxGrid) return static_cast<int>(cudaErrorInvalidValue);
  gemv_rows_kernel<T, W, WARPS, COMP><<<static_cast<unsigned>(grid), 32 * WARPS, 0, stream>>>(
      M, x, y, rows, cols, row_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool COMP>
int launch_rows(const void* M, const void* x, void* y, int batch, int rows,
                int cols, void* stream) {
  if (batch < 0 || rows < 0 || cols < 0 || !aligned_to(M, sizeof(T)) ||
      !aligned_to(x, sizeof(T))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || rows == 0) return static_cast<int>(cudaGetLastError());
  const T* Mp = static_cast<const T*>(M);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int groups = (cols + kV<T> - 1) / kV<T>;
  if (groups <= 8) return launch_rows_w<T, 8, 8, COMP>(Mp, xp, yp, batch, rows, cols, st);
  if (groups <= 16) return launch_rows_w<T, 16, 8, COMP>(Mp, xp, yp, batch, rows, cols, st);
  // blocks of 16 rows (x staged once for 16, 64 registers a thread) where
  // the grid keeps four blocks per SM; else of 8, for more blocks. The
  // compensated sums always take blocks of 8 (16-row blocks, also at 64
  // registers, ran 4% slower)
  if constexpr (!COMP) {
    if (static_cast<long long>(batch) * ((rows + 15) / 16) >= kBigGrid) {
      return launch_rows_w<T, 32, 16, COMP>(Mp, xp, yp, batch, rows, cols, st);
    }
  }
  return launch_rows_w<T, 32, 8, COMP>(Mp, xp, yp, batch, rows, cols, st);
}

template <typename T, bool COMP>
int launch_cols(const void* M, const void* u, void* y, int batch, int rows,
                int cols, int cluster, void* stream) {
  if (batch < 0 || rows < 0 || cols < 0 || cluster < 1 || cluster > kMaxCluster ||
      !aligned_to(M, sizeof(T)) || !aligned_to(u, sizeof(T))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || cols == 0) return static_cast<int>(cudaGetLastError());
  const int col_tiles = (cols + 32 * kV<T> - 1) / (32 * kV<T>);
  const long long grid = static_cast<long long>(batch) * col_tiles * cluster;
  if (grid > kMaxGrid) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* Mp = static_cast<const T*>(M);
  const T* up = static_cast<const T*>(u);
  T* yp = static_cast<T*>(y);
  if (cluster == 1) {
    gemv_cols_kernel<T, COMP><<<static_cast<unsigned>(grid), 32 * kColsWarps, 0, st>>>(
        Mp, up, yp, rows, cols, col_tiles, 1);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(32 * kColsWarps);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, gemv_cols_kernel<T, COMP>, Mp, up, yp,
                                            rows, cols, col_tiles, cluster);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes (scs_tpu_torch/ops/_kernels.py).
// The launch goes on the caller's stream and does not synchronise; the
// return value is cudaGetLastError() right after the launch (0 = success).
extern "C" int gemv_rows_f32(const void* M, const void* x, void* y, int batch,
                             int rows, int cols, void* stream) {
  return launch_rows<float, false>(M, x, y, batch, rows, cols, stream);
}

extern "C" int gemv_rows_f64(const void* M, const void* x, void* y, int batch,
                             int rows, int cols, void* stream) {
  return launch_rows<double, false>(M, x, y, batch, rows, cols, stream);
}

// cluster: blocks (1-8) the rows of a column tile are split over.
extern "C" int gemv_cols_f32(const void* M, const void* u, void* y, int batch,
                             int rows, int cols, int cluster, void* stream) {
  return launch_cols<float, false>(M, u, y, batch, rows, cols, cluster, stream);
}

extern "C" int gemv_cols_f64(const void* M, const void* u, void* y, int batch,
                             int rows, int cols, int cluster, void* stream) {
  return launch_cols<double, false>(M, u, y, batch, rows, cols, cluster, stream);
}

// D1: the compensated products, float only; the same arguments.
extern "C" int gemv_rows_comp_f32(const void* M, const void* x, void* y, int batch,
                                  int rows, int cols, void* stream) {
  return launch_rows<float, true>(M, x, y, batch, rows, cols, stream);
}

extern "C" int gemv_cols_comp_f32(const void* M, const void* u, void* y, int batch,
                                  int rows, int cols, int cluster, void* stream) {
  return launch_cols<float, true>(M, u, y, batch, rows, cols, cluster, stream);
}
