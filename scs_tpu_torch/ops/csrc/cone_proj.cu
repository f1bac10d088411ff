// Cone projections that are scalar iterations per cone: the exponential
// cone, the power cone and the box cone, for sm_90a.
//
// These replace no TPU kernel of their own: in scs_tpu
// (scs_tpu/ops/projections.py: _proj_exp_batch :289, _proj_pow_batch :403,
// _proj_box :67) they are lax.fori_loops with fixed counts that XLA fuses
// into the solver's one compiled program. Eager PyTorch would launch one
// kernel for every arithmetic line of every loop pass (the exponential
// cone: (1 + 30 + 64 + 1) solves x 40 Newton steps x ~14 lines), so the
// port runs each projection as one launch with every loop in registers.
//
// What bounds them: not bytes (a cone is three numbers in, three out) and
// not the arithmetic rate either. proj_exp and proj_pow are one thread per
// cone, each a serial chain of dependent Newton steps with a log, an exp or
// a square root and a division in each: the time is the longest chain's
// latency while the batch is small (640 cones are 20 warps on 132 SMs), and
// the special-function rate once the batch fills the card. proj_box is one
// block per problem; each Newton step is one pass over the problem's bounds
// and one block-wide reduction, so its time is steps x a barrier's latency.
//
// The arithmetic is the plain PyTorch version's
// (scs_tpu_torch/ops/projections.py: _proj_exp_batch_ref,
// _proj_pow_batch_ref, _proj_box_ref), operation by operation and in the
// same order, with the same fixed counts (scs_tpu's, but for the power
// cone's Newton step, which halves towards a bound where scs_tpu clips onto
// it: the plain version says why). A loop leaves early only where
// every later pass would repeat the last one exactly (a Newton fixed point,
// a frozen bracket), and the case masks (in cone, in polar, analytic,
// collapsed) are applied in the plain version's order. nvcc contracts a*b+c
// into one FMA and its log/exp differ from the host library's by an ulp, so
// kernel and plain version agree to a tolerance and not bit for bit.
//
// C interface (loaded with ctypes); every function returns the
// cudaGetLastError() of its launch:
//
//   proj_exp_f32/_f64(v, sign, out, evals, k, explim, stream)
//       v, out (k, 3); sign (k,) or null: rows with sign < 0 are projected
//       onto the dual cone by Moreau, v + Pi(-v); evals (k,) int32 or
//       null: the inner Newton solves the row ran
//   proj_pow_f32/_f64(v, a, sign, out, iters, k, stream)
//       v, out (k, 3); a (k,) the row's power in (0, 1); sign as above;
//       iters (k,) int32 or null: the Newton steps the row ran
//   proj_box_f32/_f64(v, bl, bu, out, iters, batch, nb, bound_stride, stream)
//       v, out (batch, nb + 1) rows (t, s); bl, bu (nb,) shared by all
//       problems (bound_stride 0) or (batch, nb) (bound_stride nb), +-inf
//       where a side is unbounded; iters (batch,) int32 or null

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

namespace {

constexpr int kExpNewton = 40;
constexpr int kExpDoublings = 30;
constexpr int kExpBisections = 64;
constexpr int kPowNewton = 40;
constexpr int kBoxNewton = 100;
constexpr int kRowThreads = 128;  // threads per block of proj_exp / proj_pow
constexpr int kBoxThreads = 256;  // threads per block (one problem) of proj_box

template <typename T> struct Num;
template <> struct Num<float> {
  static __device__ __forceinline__ float tiny() { return FLT_MIN; }
  static __device__ __forceinline__ float eps() { return FLT_EPSILON; }
};
template <> struct Num<double> {
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
  static __device__ __forceinline__ double eps() { return DBL_EPSILON; }
};

// max and min that hand a NaN on, as torch.maximum / torch.clamp do
template <typename T> __device__ __forceinline__ T maxn(T a, T b) {
  return (a > b || a != a) ? a : b;
}
template <typename T> __device__ __forceinline__ T minn(T a, T b) {
  return (a < b || a != a) ? a : b;
}
template <typename T> __device__ __forceinline__ T clampn(T x, T lo, T hi) {
  return minn(maxn(x, lo), hi);
}

// ---------------------------------------------------------------------------
// Exponential cone
// ---------------------------------------------------------------------------

// Inner Newton on t (the plain version's _exp_newton_onz).
template <typename T>
__device__ __forceinline__ T exp_newton_onz(T rho, T y_hat, T z_hat, T w) {
  T t = maxn(maxn(w - z_hat, -z_hat), T(1e-6));
  const T r2 = rho * rho;
  const T log_rho = log(rho);
  const T ry = rho * y_hat;
  for (int i = 0; i < kExpNewton; ++i) {
    const T f = t * (t + z_hat) - ry + r2 * (log(t) - log_rho + T(1));
    const T fp = T(2) * t + z_hat + r2 / t;
    T t_new = t - f / fp;
    t_new = (t_new > T(0)) ? t_new : T(0.5) * t;
    if (t_new == t) break;  // a fixed point: every later step repeats it
    t = t_new;
  }
  return t;
}

// The plain version's _exp_calc_grad: x(rho) and the gradient g.
template <typename T>
__device__ __forceinline__ T exp_calc_grad(T r, T s, T t, T rho, T warm, T x[3]) {
  const T zb = exp_newton_onz(rho, s, t, warm);
  x[2] = zb + t;
  x[1] = (T(1) / rho) * zb * x[2];
  x[0] = r - rho;
  const T tiny = Num<T>::tiny();
  if (x[1] <= T(1e-12)) return x[0];
  return x[0] + x[1] * log(maxn(x[1], tiny) / maxn(x[2], tiny));
}

template <typename T>
__device__ void proj_exp_row(T r, T s, T t, T lim, T out[3], int& evals) {
  const T tiny = Num<T>::tiny();
  const bool in_cone =
      ((s > T(0)) && (t > T(0)) && (r <= s * log(maxn(t, tiny) / maxn(s, tiny)))) ||
      ((r <= T(0)) && (s == T(0)) && (t >= T(0)));
  if (in_cone) {
    out[0] = r; out[1] = s; out[2] = t;
    return;
  }
  const T exp_r = exp(clampn(s / ((r != T(0)) ? r : T(1)), -lim, lim));
  const bool in_polar = ((-r < T(0)) && (r * exp_r <= -T(M_E) * t)) ||
                        ((r == T(0)) && (-s >= T(0)) && (-t >= T(0)));
  if (in_polar) {
    out[0] = out[1] = out[2] = T(0);
    return;
  }
  if ((r < T(0)) && (s < T(0))) {  // analytic
    out[0] = r; out[1] = T(0); out[2] = maxn(t, T(0));
    return;
  }

  // upper bound of the bracket by doubling
  T lb = T(0), rho = T(0.125);
  T x[3] = {r, s, t};
  T xn[3];
  for (int i = 0; i < kExpDoublings; ++i) {
    const T g = exp_calc_grad(r, s, t, rho, x[1], xn);
    ++evals;
    if (!(g > T(0))) break;  // rho and x stay: every later pass repeats this one
    lb = rho;
    rho = rho * T(2);
    x[0] = xn[0]; x[1] = xn[1]; x[2] = xn[2];
  }
  T ub = rho;

  const T eps = Num<T>::eps();
  const T bis_tol = T(8) * eps;
  for (int i = 0; i < kExpBisections; ++i) {
    const bool live = (ub - lb) > bis_tol * maxn(ub, T(1));
    if (!live) break;  // the bracket is frozen for good
    rho = T(0.5) * (lb + ub);
    const T g = exp_calc_grad(r, s, t, rho, x[1], xn);
    ++evals;
    if (g > T(0)) lb = rho;
    if (g <= T(0)) ub = rho;
    x[0] = xn[0]; x[1] = xn[1]; x[2] = xn[2];
  }

  // recover (x1, x2) from the stationarity equation where the direct sum
  // x2 = zb + t visibly cancelled
  const T rho_f = T(0.5) * (lb + ub);
  const T zb_f = exp_newton_onz(rho_f, s, t, x[1]);
  ++evals;
  const T x1s = s - rho_f * (log(zb_f) - log(rho_f) + T(1));
  const T x2s = rho_f * x1s / zb_f;
  const T x2d = zb_f + t;
  const bool cancel = fabs(x2d) < T(64) * eps * fabs(t);
  const bool use = isfinite(x1s) && isfinite(x2s) && (x1s >= T(0)) && (x2s >= T(0)) &&
                   (rho_f > T(0)) && cancel;
  if (use) {
    x[0] = r - rho_f; x[1] = x1s; x[2] = x2s;
  }
  // rho -> 0: the bisection collapsed onto lb = 0; the limit is the
  // boundary point at s = s0
  const bool collapsed = (lb == T(0)) && (ub <= T(2) * bis_tol);
  if (collapsed) {
    const T s_pos = maxn(s, T(0));
    const T t_lim = s_pos * exp(clampn(r / maxn(s_pos, tiny), -lim, lim));
    x[0] = r; x[1] = s_pos; x[2] = maxn(t_lim, T(0));
  }
  out[0] = x[0]; out[1] = x[1]; out[2] = x[2];
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
proj_exp_kernel(const T* __restrict__ v, const T* __restrict__ sign, T* __restrict__ out,
                int* __restrict__ evals, int k, T lim) {
  const int row = blockIdx.x * kRowThreads + threadIdx.x;
  if (row >= k) return;
  const T v0 = v[3 * row], v1 = v[3 * row + 1], v2 = v[3 * row + 2];
  const bool dual = sign != nullptr && sign[row] < T(0);
  const T sg = (sign != nullptr) ? sign[row] : T(1);
  T p[3];
  int n_evals = 0;
  proj_exp_row<T>(v0 * sg, v1 * sg, v2 * sg, lim, p, n_evals);
  out[3 * row] = dual ? v0 + p[0] : p[0];
  out[3 * row + 1] = dual ? v1 + p[1] : p[1];
  out[3 * row + 2] = dual ? v2 + p[2] : p[2];
  if (evals != nullptr) evals[row] = n_evals;
}

// ---------------------------------------------------------------------------
// Power cone
// ---------------------------------------------------------------------------

template <typename T> __device__ __forceinline__ T safe_pow(T base, T e) {
  return exp(e * log(maxn(base, Num<T>::tiny())));
}

template <typename T> __device__ __forceinline__ T pow_calc_x(T r, T xh, T aa, T rh) {
  return maxn(T(0.5) * (xh + sqrt(xh * xh + T(4) * aa * (rh - r) * r)), T(1e-12));
}

template <typename T>
__device__ void proj_pow_row(T x0, T y0, T z0, T a, T out[3], int& iters) {
  const T b = T(1) - a;
  const T rh = fabs(z0);
  const bool in_cone =
      (x0 >= T(0)) && (y0 >= T(0)) && (safe_pow(x0, a) * safe_pow(y0, b) >= rh);
  if (in_cone) {
    out[0] = x0; out[1] = y0; out[2] = z0;
    return;
  }
  const bool in_polar = (x0 <= T(0)) && (y0 <= T(0)) &&
                        (safe_pow(-x0 / a, a) * safe_pow(-y0 / b, b) >= rh);
  if (in_polar) {
    out[0] = out[1] = out[2] = T(0);
    return;
  }
  T r = rh / T(2);
  for (int i = 0; i < kPowNewton; ++i) {
    const T x = pow_calc_x(r, x0, a, rh);
    const T y = pow_calc_x(r, y0, b, rh);
    const T xy = safe_pow(x, a) * safe_pow(y, b);
    const T f = xy - r;
    ++iters;
    if (fabs(f) < T(1e-12)) break;  // r is kept, and so is f: a fixed point
    const T dxdr = a * (rh - T(2) * r) / (T(2) * x - x0);
    const T dydr = b * (rh - T(2) * r) / (T(2) * y - y0);
    const T fp = xy * (a * dxdr / x + b * dydr / y) - T(1);
    // a step past an end of [0, rh] goes half way to that end, not onto it
    // (on r = rh an f32 iterate would stay for good: see the plain version)
    const T step = r - f / fp;
    const T r_new = (step > rh) ? T(0.5) * (r + rh) : ((step < T(0)) ? T(0.5) * r : step);
    if (r_new == r) break;  // a fixed point: every later step repeats it
    r = r_new;
  }
  out[0] = pow_calc_x(r, x0, a, rh);
  out[1] = pow_calc_x(r, y0, b, rh);
  const T sgn = (z0 > T(0)) ? T(1) : ((z0 < T(0)) ? T(-1) : z0);
  out[2] = sgn * r;
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
proj_pow_kernel(const T* __restrict__ v, const T* __restrict__ a, const T* __restrict__ sign,
                T* __restrict__ out, int* __restrict__ iters, int k) {
  const int row = blockIdx.x * kRowThreads + threadIdx.x;
  if (row >= k) return;
  const T v0 = v[3 * row], v1 = v[3 * row + 1], v2 = v[3 * row + 2];
  const bool dual = sign != nullptr && sign[row] < T(0);
  const T sg = (sign != nullptr) ? sign[row] : T(1);
  T p[3];
  int n_iters = 0;
  proj_pow_row<T>(v0 * sg, v1 * sg, v2 * sg, a[row], p, n_iters);
  out[3 * row] = dual ? v0 + p[0] : p[0];
  out[3 * row + 1] = dual ? v1 + p[1] : p[1];
  out[3 * row + 2] = dual ? v2 + p[2] : p[2];
  if (iters != nullptr) iters[row] = n_iters;
}

// ---------------------------------------------------------------------------
// Box cone: one block per problem
// ---------------------------------------------------------------------------

// Sum (g, h) over the block in a fixed order (lanes by shuffle, then the
// warps' partial sums in warp order): the same inputs give the same bits
// from launch to launch. Every thread returns the block's sums.
template <typename T>
__device__ __forceinline__ void block_sum2(T& g, T& h, T* scratch) {
  for (int off = 16; off > 0; off >>= 1) {
    g += __shfl_down_sync(0xffffffffu, g, off);
    h += __shfl_down_sync(0xffffffffu, h, off);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kWarps = kBoxThreads / 32;
  __syncthreads();  // the last round's readers are done with scratch
  if (lane == 0) {
    scratch[2 * warp] = g;
    scratch[2 * warp + 1] = h;
  }
  __syncthreads();
  g = T(0);
  h = T(0);
  for (int w = 0; w < kWarps; ++w) {
    g += scratch[2 * w];
    h += scratch[2 * w + 1];
  }
}

template <typename T>
__global__ void __launch_bounds__(kBoxThreads)
proj_box_kernel(const T* __restrict__ v, const T* __restrict__ bl, const T* __restrict__ bu,
                T* __restrict__ out, int* __restrict__ iters, int nb, int bound_stride) {
  __shared__ T scratch[2 * (kBoxThreads / 32)];
  const int prob = blockIdx.x;
  const T* vp = v + (size_t)prob * (nb + 1);
  const T* s0 = vp + 1;
  const T* lo_b = bl + (size_t)prob * bound_stride;
  const T* hi_b = bu + (size_t)prob * bound_stride;
  T* op = out + (size_t)prob * (nb + 1);
  const T t0 = vp[0];

  T t = maxn(t0, T(0));
  int n_iters = 0;
  for (int it = 0; it < kBoxNewton; ++it) {
    T g = T(0), h = T(0);
    for (int j = threadIdx.x; j < nb; j += kBoxThreads) {
      const T l = lo_b[j], u = hi_b[j], s = s0[j];
      const bool fin_l = isfinite(l), fin_u = isfinite(u);
      const T lf = fin_l ? l : T(0), uf = fin_u ? u : T(0);
      if (fin_u && (s > uf * t)) {
        g += uf * (uf * t - s);
        h += uf * uf;
      }
      if (fin_l && (s < lf * t)) {
        g += lf * (lf * t - s);
        h += lf * lf;
      }
    }
    block_sum2(g, h, scratch);
    g = (t - t0) + g;
    h = T(1) + h;
    const T t_new = maxn(t - g / h, T(0));
    ++n_iters;
    if (t_new == t) break;  // a fixed point: every later step repeats it
    t = t_new;
  }
  for (int j = threadIdx.x; j < nb; j += kBoxThreads) {
    const T l = lo_b[j], u = hi_b[j];
    const T lo = isfinite(l) ? l * t : -INFINITY;
    const T hi = isfinite(u) ? u * t : INFINITY;
    op[1 + j] = minn(maxn(s0[j], lo), hi);
  }
  if (threadIdx.x == 0) {
    op[0] = t;
    if (iters != nullptr) iters[prob] = n_iters;
  }
}

template <typename T>
int launch_exp(const void* v, const void* sign, void* out, int* evals, int k, double lim,
               void* stream) {
  if (k <= 0) return 0;
  const int blocks = (k + kRowThreads - 1) / kRowThreads;
  proj_exp_kernel<T><<<blocks, kRowThreads, 0, (cudaStream_t)stream>>>(
      (const T*)v, (const T*)sign, (T*)out, evals, k, (T)lim);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pow(const void* v, const void* a, const void* sign, void* out, int* iters, int k,
               void* stream) {
  if (k <= 0) return 0;
  const int blocks = (k + kRowThreads - 1) / kRowThreads;
  proj_pow_kernel<T><<<blocks, kRowThreads, 0, (cudaStream_t)stream>>>(
      (const T*)v, (const T*)a, (const T*)sign, (T*)out, iters, k);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_box(const void* v, const void* bl, const void* bu, void* out, int* iters, int batch,
               int nb, int bound_stride, void* stream) {
  if (batch <= 0) return 0;
  proj_box_kernel<T><<<batch, kBoxThreads, 0, (cudaStream_t)stream>>>(
      (const T*)v, (const T*)bl, (const T*)bu, (T*)out, iters, nb, bound_stride);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int proj_exp_f32(const void* v, const void* sign, void* out, int* evals, int k, double explim,
                 void* stream) {
  return launch_exp<float>(v, sign, out, evals, k, explim, stream);
}
int proj_exp_f64(const void* v, const void* sign, void* out, int* evals, int k, double explim,
                 void* stream) {
  return launch_exp<double>(v, sign, out, evals, k, explim, stream);
}
int proj_pow_f32(const void* v, const void* a, const void* sign, void* out, int* iters, int k,
                 void* stream) {
  return launch_pow<float>(v, a, sign, out, iters, k, stream);
}
int proj_pow_f64(const void* v, const void* a, const void* sign, void* out, int* iters, int k,
                 void* stream) {
  return launch_pow<double>(v, a, sign, out, iters, k, stream);
}
int proj_box_f32(const void* v, const void* bl, const void* bu, void* out, int* iters, int batch,
                 int nb, int bound_stride, void* stream) {
  return launch_box<float>(v, bl, bu, out, iters, batch, nb, bound_stride, stream);
}
int proj_box_f64(const void* v, const void* bl, const void* bu, void* out, int* iters, int batch,
                 int nb, int bound_stride, void* stream) {
  return launch_box<double>(v, bl, bu, out, iters, batch, nb, bound_stride, stream);
}

}  // extern "C"
