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
// not the arithmetic rate either, but the latency of chains of dependent
// Newton steps, each with a log, an exp or a square root and a division.
//
// proj_exp: a cone needs up to 30 doublings of rho, up to 64 bisections
// and a final solve, each an inner Newton of up to 40 steps, and each
// warm-started from the one before: one thread per cone (the first design)
// runs up to 95 solves in a row, and at the mixed_cone cell's 1,280 cones
// those chains run on 40 warps of a 132-SM card. So a cone gets a group of
// G lanes (G in 1, 4, 8, 16, 32). The wrapper picks G from the cone count
// (ops/projections.py: exp_group): many lanes where cones are few, one
// where the cones alone fill the card, since the tree's nodes that are
// evaluated and not taken multiply the work:
//   * doubling: the lanes evaluate g at rho = 0.125 * 2^j for G consecutive
//     j in one round, all warm-started from the last round's x; the first j
//     with g <= 0 (a ballot) gives the serial loop's bracket, since powers
//     of two are exact. Up to 30 solves in a row become ceil(30 / G) rounds;
//   * bisection: G - 1 lanes evaluate the nodes of the next log2(G) levels
//     of the bisection tree, each node the midpoint of its bracket computed
//     as the serial loop computes it, and the group then walks down the
//     tree by the signs of g (shuffles): the same brackets, x and stopping
//     test (width <= 8 eps max(ub, 1)) as the serial loop, log2(G) steps a
//     round (G = 1 is the serial schedule);
//   * the final recovery solve and the case masks run on the group's first
//     lane, in the plain version's order.
// The inner Newton leaves at a fixed point (every later step repeats it)
// and on a cycle (t_{i+1} == t_{i+1-p}: the map repeats the p points for
// good; a two-cycle between neighbouring floats is common, periods of 3 to
// a dozen occur), where it returns the point the plain version's fixed count of
// 40 ends on: by the parity of the steps left for a two-cycle, else by
// stepping on (n - i - 1) mod p times. These exits are exact for the
// kernel's own map (newton_fixed_count). The cycle tests start after the
// first 4 steps, within which many solves reach a fixed point: there a
// step costs what the first design's did, which one lane a cone (where the
// cones fill the card) needs to stay level with it; a cycle is then seen
// a few steps later than it could be. A lane's warm start
// is farther from its rho than the serial loop's, so the lanes' x can
// differ from the serial loop's by the inner Newton's last rounding, and a
// g within that of 0 can flip; the result agrees with the plain version to
// the stated tolerance, as the first design's did.
//
// proj_pow: one thread per cone, a chain of up to 40 Newton steps, left at
// a fixed point. The step is a function of r alone, so a row could also
// leave on a cycle, exactly; but most f32 rows that cycle sit in warps that
// hold a row which wanders all 40 steps without repeating, so where the
// cones fit in one wave (every shape the solver hands it) the time is the
// launch plus 40 steps of one chain whatever the exits. Exits on two-cycles
// (parity) and on cycles of any period (newton_fixed_count), and two lanes
// a cone (the x and y halves of a step), were each measured on the
// solver's rows and were slower than this loop; the lane pairs did not
// give its bits either.
//
// proj_box: each Newton step on t is a pass over the problem's bounds and
// one reduction over them, up to 100 steps; the first design (a 256-thread
// block a problem) re-read the bounds from L2 and paid two barriers every
// step, and ran all 100 steps on rows whose t cycles between a few
// neighbouring floats. Now the bounds, finite-masked, and s are loaded once
// into registers; a problem of up to 512 bounds is one warp (four problems a
// block) and reduces by shuffles alone; a wider one is a 256-thread block
// with one barrier a step and double-buffered scratch. t leaves at a fixed
// point and on a cycle, against the fixed count of 100, as above.
//
// The arithmetic is the plain PyTorch version's
// (scs_tpu_torch/ops/projections.py: _proj_exp_batch_ref,
// _proj_pow_batch_ref, _proj_box_ref), operation by operation and in the
// same order, with the same fixed counts (scs_tpu's, but for the power
// cone's Newton step, which halves towards a bound where scs_tpu clips onto
// it: the plain version says why). A loop leaves early only where every
// later pass would repeat earlier ones exactly (a fixed point, a cycle, a
// frozen bracket), and the case masks (in cone, in
// polar, analytic, collapsed) are applied in the plain version's order.
// Every sum runs in an order fixed by the shape, so a repeated launch gives
// the same bits. nvcc contracts a*b+c into one FMA and its log/exp differ
// from the host library's by an ulp, so kernel and plain version agree to
// a tolerance and not bit for bit.
//
// C interface (loaded with ctypes); every function returns the
// cudaGetLastError() of its launch:
//
//   proj_exp_f32/_f64(v, sign, out, evals, steps, cycles, k, group, explim, stream)
//       v, out (k, 3); sign (k,) or null: rows with sign < 0 are projected
//       onto the dual cone by Moreau, v + Pi(-v); evals, steps, cycles (k,)
//       int32 or null: the inner Newton solves on the serial loop's path
//       (the plain version's count), their Newton steps, and how many of
//       them left on a cycle; group: lanes per cone, 1, 4, 8, 16 or 32
//       (anything else is cudaErrorInvalidValue)
//   proj_pow_f32/_f64(v, a, sign, out, iters, k, stream)
//       v, out (k, 3); a (k,) the row's power in (0, 1); sign as above;
//       iters (k,) int32 or null: the Newton steps the row ran
//   proj_box_f32/_f64(v, bl, bu, out, iters, cycles, batch, nb, bound_stride, stream)
//       v, out (batch, nb + 1) rows (t, s); bl, bu (nb,) shared by all
//       problems (bound_stride 0) or (batch, nb) (bound_stride nb), +-inf
//       where a side is unbounded; iters, cycles (batch,) int32 or null: the
//       Newton steps the problem ran, and 1 where it left on a cycle

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

namespace {

constexpr int kExpNewton = 40;
constexpr int kExpDoublings = 30;
constexpr int kExpBisections = 64;
// inner Newton steps before the cycle tests start (most solves end sooner)
constexpr int kExpPlainSteps = 4;
constexpr int kPowNewton = 40;
constexpr int kBoxNewton = 100;
constexpr int kRowThreads = 128;  // threads per block of proj_exp / proj_pow
constexpr int kBoxWarpSlots = 16;  // bounds a lane holds: one warp a problem up to 512
constexpr int kBoxWarps = 4;       // problems (warps) a block in the warp design
constexpr int kBoxThreads = 256;   // threads a block (one problem) in the block design

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

// What one lane's solves cost: Newton steps, and solves that left on a
// cycle.
struct Tally {
  int steps = 0, cycles = 0;
};

// Where a Newton iteration of a fixed count of n steps may leave early: the
// map t -> t_new is a function of t alone, so once an iterate repeats
// (t_{i+1} == t_{i+1-p}) every later one repeats with period p, and step n
// lands on the iterate (n - i - 1) mod p steps past t_{i+1}. Repeats are
// looked for against t_i (a fixed point), t_{i-1} (a two-cycle: the point
// is chosen by parity) and a checkpoint kept at steps kFrom, 2 kFrom, ...
// (powers of two from 1 where kFrom is 0; Brent's: any longer period, once
// the checkpoint lies on the cycle; the few steps left are then run).
struct CycleExit {
  int steps = 0;  // steps run, the remainder's included
  bool cycled = false;
};

// N steps at most, unrolled kUnroll-fold. The first kFrom steps test for a
// fixed point alone, as the first design did at every step: most solves
// end within them and pay nothing for the cycle tests. After them a step's
// only test is still one predicate whose branch leaves the loop: nothing
// on the chain of steps waits at a convergence barrier. The cycle tests
// look at t_i, known before step i starts, so they run beside the step and
// only t_{i+1} == t_i stays on the chain; a cycle is seen one step later
// than it could be, and that step is not wasted (it is the first of those
// left). What the exit was, and a longer cycle's few remaining steps, are
// worked out after the loop.
template <int N, int kFrom, int kUnroll, typename T, typename Step>
__device__ __forceinline__ T newton_fixed_count(T t, Step step, CycleExit& ex) {
  int i = 0;
#pragma unroll kUnroll
  for (; i < kFrom; ++i) {
    const T t_new = step(t);
    if (t_new == t) {  // a fixed point
      ex.steps += i + 1;
      return t;
    }
    t = t_new;
  }
  const T none = T(NAN);  // equal to nothing: no iterate before t_kFrom
  T t_prev = none, t_prev2 = none, saved = none, t_new = t;
  int at = 0, at_seen = 0;  // the checkpoint's step, now and when t_i was tested
  bool cycle = false;
#pragma unroll kUnroll
  for (; i < N; ++i) {
    // t = t_i: does it repeat t_{i-2} or the checkpoint?
    cycle = (t == t_prev2) | (t == saved);
    at_seen = at;
    const bool checkpoint = (i & (i - 1)) == 0;  // i a power of two (or 0)
    saved = checkpoint ? t : saved;
    at = checkpoint ? i : at;
    t_new = step(t);
    if ((t_new == t) | cycle) break;
    t_prev2 = t_prev;
    t_prev = t;
    t = t_new;
  }
  if (i == N) {
    ex.steps += N;
    return t;
  }
  ex.steps += i + 1;
  if (!cycle) return t;  // a fixed point
  // t_i repeats t_{i-2} (period 2) or t_at_seen: step N lands (N - i) mod p
  // steps past t_i, and t_new is t_{i+1}, the first of them
  ex.cycled = true;
  const int left = (N - i) % ((t == t_prev2) ? 2 : i - at_seen);
  if (left == 0) return t;
  for (int j = 1; j < left; ++j) t_new = step(t_new);
  ex.steps += left - 1;
  return t_new;
}

// Inner Newton on t (the plain version's _exp_newton_onz).
template <typename T>
__device__ __forceinline__ T exp_newton_onz(T rho, T y_hat, T z_hat, T w, Tally& n) {
  const T t0 = maxn(maxn(w - z_hat, -z_hat), T(1e-6));
  const T r2 = rho * rho;
  const T log_rho = log(rho);
  const T ry = rho * y_hat;
  const auto step = [&](T t) {
    const T f = t * (t + z_hat) - ry + r2 * (log(t) - log_rho + T(1));
    const T fp = T(2) * t + z_hat + r2 / t;
    const T t_new = t - f / fp;
    return (t_new > T(0)) ? t_new : T(0.5) * t;
  };
  CycleExit ex;
  const T t = newton_fixed_count<kExpNewton, kExpPlainSteps, 2>(t0, step, ex);
  n.steps += ex.steps;
  n.cycles += ex.cycled;
  return t;
}

// The plain version's _exp_calc_grad: x(rho) = (r - rho, x1, x2) and g.
template <typename T>
__device__ __forceinline__ T exp_calc_grad(T r, T s, T t, T rho, T warm, T& x1, T& x2, Tally& n) {
  const T zb = exp_newton_onz(rho, s, t, warm, n);
  x2 = zb + t;
  x1 = (T(1) / rho) * zb * x2;
  const T x0 = r - rho;
  const T tiny = Num<T>::tiny();
  if (x1 <= T(1e-12)) return x0;
  return x0 + x1 * log(maxn(x1, tiny) / maxn(x2, tiny));
}

// The lanes of a group of G (G a power of two, at most 32) inside its warp.
// Every collective names the whole warp, so the warp's groups run the same
// rounds side by side; a group with nothing left to do sits them out under
// a predicate. A group of one lane needs no collective: each lane runs its
// own rounds, as one thread a cone did.
template <int G> struct Group {
  static constexpr unsigned kAll = 0xffffffffu;
  unsigned base;
  __device__ __forceinline__ Group() : base((threadIdx.x & 31u) & ~unsigned(G - 1)) {}
  // the group's bits of a warp-wide ballot, lane 0 of the group in bit 0
  __device__ __forceinline__ unsigned ballot(bool p) const {
    if constexpr (G == 1) return p ? 1u : 0u;
    const unsigned bits = __ballot_sync(kAll, p) >> base;
    return (G == 32) ? bits : (bits & ((1u << G) - 1u));
  }
  template <typename V> __device__ __forceinline__ V from(V x, int src) const {
    if constexpr (G == 1) return x;
    return __shfl_sync(kAll, x, src, G);
  }
  __device__ __forceinline__ int sum(int x) const {
    for (int off = G / 2; off > 0; off >>= 1) x += __shfl_xor_sync(kAll, x, off, G);
    return x;
  }
  // whether a round is left for any group of the warp (G = 1: for this lane)
  __device__ __forceinline__ static bool any(bool p) {
    if constexpr (G == 1) return p;
    return __any_sync(kAll, p);
  }
};

// One cone (r, s, t) on a group of G lanes, lane q of it, every lane of
// the warp calling (busy false: a lane past the last cone). Lane 0 returns
// the projection in out; evals: the serial loop's solves; n: the Newton
// steps of those solves, summed over the group.
template <typename T, int G>
__device__ void proj_exp_row(bool busy, T r, T s, T t, T lim, int q, const Group<G>& grp,
                             T out[3], int& evals, Tally& n) {
  const T tiny = Num<T>::tiny();
  const bool in_cone =
      ((s > T(0)) && (t > T(0)) && (r <= s * log(maxn(t, tiny) / maxn(s, tiny)))) ||
      ((r <= T(0)) && (s == T(0)) && (t >= T(0)));
  const T exp_r = exp(clampn(s / ((r != T(0)) ? r : T(1)), -lim, lim));
  const bool in_polar = ((-r < T(0)) && (r * exp_r <= -T(M_E) * t)) ||
                        ((r == T(0)) && (-s >= T(0)) && (-t >= T(0)));
  const bool analytic = (r < T(0)) && (s < T(0));
  busy = busy && !in_cone && !in_polar && !analytic;

  // x = (x0, x1, x2) of the serial loop's last accepted solve; mine: this
  // lane's solves, counted where they lie on the serial path
  T x0 = r, x1 = s, x2 = t;
  Tally mine;

  // upper bound of the bracket by doubling, G doublings a round
  T lb = T(0), ub = T(0);
  bool doubling = busy;
  for (int j0 = 0; Group<G>::any(doubling); j0 += G) {
    const int j = j0 + q;
    const bool valid = doubling && j < kExpDoublings;
    const T rho = T(0.125) * T(1u << (valid ? j : 0));  // exact: a power of two
    T g = T(0), xn1 = T(0), xn2 = T(0);
    Tally lane;
    if (valid) g = exp_calc_grad(r, s, t, rho, x1, xn1, xn2, lane);
    // the first doubling whose g is not > 0 ends the loop, as in the serial one
    const unsigned stop = grp.ballot(valid && !(g > T(0)));
    const int last = stop ? (__ffs(stop) - 1) : min(G, kExpDoublings - j0) - 1;
    // x and lb move to the last doubling whose g was > 0, if there was one
    const int grown = stop ? last - 1 : last;
    const T gx1 = grp.from(xn1, max(grown, 0));
    const T gx2 = grp.from(xn2, max(grown, 0));
    if (doubling) {
      if (q <= last) {
        mine.steps += lane.steps;
        mine.cycles += lane.cycles;
      }
      evals += last + 1;
      if (grown >= 0) {
        lb = T(0.125) * T(1u << (j0 + grown));
        x0 = r - lb;
        x1 = gx1;
        x2 = gx2;
      }
      if (stop) {
        ub = T(0.125) * T(1u << (j0 + last));
        doubling = false;
      } else if (j0 + G >= kExpDoublings) {  // every doubling grew
        ub = T(0.125) * T(1u << (kExpDoublings - 1)) * T(2);
        doubling = false;
      }
    }
  }

  // bisection, `levels` levels of the bisection tree a round: lane q holds
  // node q + 1 (heap order: the root 1, the children of h are 2h and 2h + 1)
  constexpr int levels = (G >= 32) ? 5 : (G >= 16) ? 4 : (G >= 8) ? 3 : (G >= 4) ? 2 : 1;
  const T eps = Num<T>::eps();
  const T bis_tol = T(8) * eps;
  int done = 0;
  bool bisecting = busy;
  while (Group<G>::any(bisecting)) {
    const int depth = min(levels, kExpBisections - done);
    const int h = q + 1;
    const int lvl = 31 - __clz(h);
    // the node's rho: the serial loop's midpoints down from (lb, ub), as
    // long as the bracket stays live on the way
    bool evaluated = bisecting && lvl < depth;
    T rho = T(0);
    if (evaluated) {
      T lo = lb, hi = ub;
      for (int l = 0;; ++l) {
        if (!((hi - lo) > bis_tol * maxn(hi, T(1)))) {
          evaluated = false;
          break;
        }
        const T mid = T(0.5) * (lo + hi);
        if (l == lvl) {
          rho = mid;
          break;
        }
        if ((h >> (lvl - 1 - l)) & 1) lo = mid; else hi = mid;
      }
    }
    T g = T(0), xn1 = T(0), xn2 = T(0);
    Tally lane;
    if (evaluated) g = exp_calc_grad(r, s, t, rho, x1, xn1, xn2, lane);
    // walk down the tree as the serial loop would
    int node = 1;
    bool walking = bisecting;
    for (int l = 0; l < levels; ++l) {
      const T gh = grp.from(g, node - 1);
      const T h1 = grp.from(xn1, node - 1);
      const T h2 = grp.from(xn2, node - 1);
      if (!walking) continue;
      if (l >= depth) {
        walking = false;
        continue;
      }
      if (!((ub - lb) > bis_tol * maxn(ub, T(1)))) {  // the bracket is frozen for good
        walking = bisecting = false;
        continue;
      }
      const T mid = T(0.5) * (lb + ub);
      x0 = r - mid;
      x1 = h1;
      x2 = h2;
      if (q == node - 1) {
        mine.steps += lane.steps;
        mine.cycles += lane.cycles;
      }
      ++evals;
      ++done;
      if (gh > T(0)) lb = mid;
      if (gh <= T(0)) ub = mid;
      if (gh != gh) {
        // g is NaN, and so is x: every later pass repeats this one, with
        // the bracket as it is, to the end of the fixed count
        evals += kExpBisections - done;
        walking = bisecting = false;
        continue;
      }
      node = 2 * node + ((gh > T(0)) ? 1 : 0);
    }
    if (done >= kExpBisections) bisecting = false;
  }
  n.steps += grp.sum(mine.steps);
  n.cycles += grp.sum(mine.cycles);
  if (q != 0) return;
  if (in_cone) {
    out[0] = r; out[1] = s; out[2] = t;
    return;
  }
  if (in_polar) {
    out[0] = out[1] = out[2] = T(0);
    return;
  }
  if (analytic) {
    out[0] = r; out[1] = T(0); out[2] = maxn(t, T(0));
    return;
  }
  if (!busy) return;

  // recover (x1, x2) from the stationarity equation where the direct sum
  // x2 = zb + t visibly cancelled
  const T rho_f = T(0.5) * (lb + ub);
  const T zb_f = exp_newton_onz(rho_f, s, t, x1, n);
  ++evals;
  const T x1s = s - rho_f * (log(zb_f) - log(rho_f) + T(1));
  const T x2s = rho_f * x1s / zb_f;
  const T x2d = zb_f + t;
  const bool cancel = fabs(x2d) < T(64) * eps * fabs(t);
  const bool use = isfinite(x1s) && isfinite(x2s) && (x1s >= T(0)) && (x2s >= T(0)) &&
                   (rho_f > T(0)) && cancel;
  if (use) {
    x0 = r - rho_f; x1 = x1s; x2 = x2s;
  }
  // rho -> 0: the bisection collapsed onto lb = 0; the limit is the
  // boundary point at s = s0
  const bool collapsed = (lb == T(0)) && (ub <= T(2) * bis_tol);
  if (collapsed) {
    const T s_pos = maxn(s, T(0));
    const T t_lim = s_pos * exp(clampn(r / maxn(s_pos, tiny), -lim, lim));
    x0 = r; x1 = s_pos; x2 = maxn(t_lim, T(0));
  }
  out[0] = x0; out[1] = x1; out[2] = x2;
}

template <typename T, int G>
__global__ void __launch_bounds__(kRowThreads)
proj_exp_kernel(const T* __restrict__ v, const T* __restrict__ sign, T* __restrict__ out,
                int* __restrict__ evals, int* __restrict__ steps, int* __restrict__ cycles, int k,
                T lim) {
  // whole warps run (the grid is rounded up to them): a lane past the
  // last cone takes part in its warp's collectives with nothing to do
  const int row = (blockIdx.x * kRowThreads + threadIdx.x) / G;
  const bool have = row < k;
  const int q = threadIdx.x & (G - 1);
  const Group<G> grp;
  const T v0 = have ? v[3 * row] : T(0), v1 = have ? v[3 * row + 1] : T(0);
  const T v2 = have ? v[3 * row + 2] : T(0);
  const bool dual = have && sign != nullptr && sign[row] < T(0);
  const T sg = (have && sign != nullptr) ? sign[row] : T(1);
  T p[3];
  int n_evals = 0;
  Tally n;
  proj_exp_row<T, G>(have, v0 * sg, v1 * sg, v2 * sg, lim, q, grp, p, n_evals, n);
  if (q != 0 || !have) return;
  out[3 * row] = dual ? v0 + p[0] : p[0];
  out[3 * row + 1] = dual ? v1 + p[1] : p[1];
  out[3 * row + 2] = dual ? v2 + p[2] : p[2];
  if (evals != nullptr) evals[row] = n_evals;
  if (steps != nullptr) steps[row] = n.steps;
  if (cycles != nullptr) cycles[row] = n.cycles;
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
// Box cone: one warp (kWarp) or one block a problem
// ---------------------------------------------------------------------------

// The four partial sums of a Newton step: g and h over the upper and over
// the lower bounds, as the plain version keeps them apart.
template <typename T> struct BoxSums {
  T gu, gl, hu, hl;
  __device__ __forceinline__ void add_xor(unsigned off) {
    // a + b == b + a bit for bit, so every lane ends with the same sums
    gu += __shfl_xor_sync(0xffffffffu, gu, off);
    gl += __shfl_xor_sync(0xffffffffu, gl, off);
    hu += __shfl_xor_sync(0xffffffffu, hu, off);
    hl += __shfl_xor_sync(0xffffffffu, hl, off);
  }
};

// One bound's terms at t, where that side is finite and active.
template <typename T>
__device__ __forceinline__ void box_terms(T s, T l, T u, bool fin_l, bool fin_u, T t,
                                          BoxSums<T>& a) {
  if (fin_u && (s > u * t)) {
    a.gu += u * (u * t - s);
    a.hu += u * u;
  }
  if (fin_l && (s < l * t)) {
    a.gl += l * (l * t - s);
    a.hl += l * l;
  }
}

// P bounds a thread held in registers (element tid + i * threads, i < P),
// the rest (block design, beyond P * kBoxThreads) read from memory each
// step. Every sum runs in an order fixed by (nb, design): the slots in
// order, then the tail, then the lanes by butterfly, then (block) the warps
// in order.
template <typename T, int P, bool kWarp>
__global__ void __launch_bounds__(kWarp ? 32 * kBoxWarps : kBoxThreads)
proj_box_kernel(const T* __restrict__ v, const T* __restrict__ bl, const T* __restrict__ bu,
                T* __restrict__ out, int* __restrict__ iters, int* __restrict__ cycles,
                int batch, int nb, int bound_stride) {
  constexpr int kThreads = kWarp ? 32 : kBoxThreads;
  constexpr int kWarpsPer = kBoxThreads / 32;
  __shared__ T scratch[kWarp ? 1 : 2 * 4 * kWarpsPer];  // two buffers of 4 sums per warp
  const int prob = kWarp ? blockIdx.x * kBoxWarps + (threadIdx.x >> 5) : blockIdx.x;
  const int tid = kWarp ? (threadIdx.x & 31) : threadIdx.x;
  if (prob >= batch) return;  // a whole warp (warp design only)
  const T* vp = v + (size_t)prob * (nb + 1);
  const T* s0 = vp + 1;
  const T* lo_b = bl + (size_t)prob * bound_stride;
  const T* hi_b = bu + (size_t)prob * bound_stride;
  T* op = out + (size_t)prob * (nb + 1);
  const T t0 = vp[0];

  // the bounds once, finite-masked, and s
  T s_[P], l_[P], u_[P];
  unsigned fin_l = 0u, fin_u = 0u;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int j = tid + i * kThreads;
    s_[i] = l_[i] = u_[i] = T(0);
    if (j < nb) {
      const T l = lo_b[j], u = hi_b[j];
      s_[i] = s0[j];
      if (isfinite(l)) { l_[i] = l; fin_l |= 1u << i; }
      if (isfinite(u)) { u_[i] = u; fin_u |= 1u << i; }
    }
  }
  const int tail = P * kThreads;  // block design: bounds past the registers

  int it = 0;  // the step, for the scratch buffer
  const auto step = [&](T t) {
    BoxSums<T> a = {T(0), T(0), T(0), T(0)};
#pragma unroll
    for (int i = 0; i < P; ++i)
      box_terms(s_[i], l_[i], u_[i], (fin_l >> i) & 1u, (fin_u >> i) & 1u, t, a);
    if (!kWarp) {
      for (int j = tail + tid; j < nb; j += kThreads) {
        const T l = lo_b[j], u = hi_b[j];
        const bool fl = isfinite(l), fu = isfinite(u);
        box_terms(s0[j], fl ? l : T(0), fu ? u : T(0), fl, fu, t, a);
      }
    }
    for (unsigned off = 16; off > 0; off >>= 1) a.add_xor(off);
    if (!kWarp) {
      // one barrier a step: step it writes buffer it & 1, and a thread can
      // write it again only after the next step's barrier, which every
      // reader of this step has passed
      T* buf = scratch + (it & 1) * 4 * kWarpsPer;
      const int warp = threadIdx.x >> 5;
      if ((threadIdx.x & 31) == 0) {
        buf[4 * warp] = a.gu; buf[4 * warp + 1] = a.gl;
        buf[4 * warp + 2] = a.hu; buf[4 * warp + 3] = a.hl;
      }
      __syncthreads();
      a = {T(0), T(0), T(0), T(0)};
      for (int w = 0; w < kWarpsPer; ++w) {
        a.gu += buf[4 * w]; a.gl += buf[4 * w + 1];
        a.hu += buf[4 * w + 2]; a.hl += buf[4 * w + 3];
      }
    }
    ++it;
    const T g = ((t - t0) + a.gu) + a.gl;
    const T h = (T(1) + a.hu) + a.hl;
    return maxn(t - g / h, T(0));
  };
  CycleExit ex;
  const T t = newton_fixed_count<kBoxNewton, 0, 1>(maxn(t0, T(0)), step, ex);
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int j = tid + i * kThreads;
    if (j < nb) {
      const T lo = ((fin_l >> i) & 1u) ? l_[i] * t : -INFINITY;
      const T hi = ((fin_u >> i) & 1u) ? u_[i] * t : INFINITY;
      op[1 + j] = minn(maxn(s_[i], lo), hi);
    }
  }
  if (!kWarp) {
    for (int j = tail + tid; j < nb; j += kThreads) {
      const T l = lo_b[j], u = hi_b[j];
      const T lo = isfinite(l) ? l * t : -INFINITY;
      const T hi = isfinite(u) ? u * t : INFINITY;
      op[1 + j] = minn(maxn(s0[j], lo), hi);
    }
  }
  if (tid == 0) {
    op[0] = t;
    if (iters != nullptr) iters[prob] = ex.steps;
    if (cycles != nullptr) cycles[prob] = ex.cycled;
  }
}

template <typename T, int G>
void launch_exp_group(const void* v, const void* sign, void* out, int* evals, int* steps,
                      int* cycles, int k, double lim, cudaStream_t stream) {
  const long long threads = (long long)k * G;
  const int blocks = (int)((threads + kRowThreads - 1) / kRowThreads);
  proj_exp_kernel<T, G><<<blocks, kRowThreads, 0, stream>>>(
      (const T*)v, (const T*)sign, (T*)out, evals, steps, cycles, k, (T)lim);
}

template <typename T>
int launch_exp(const void* v, const void* sign, void* out, int* evals, int* steps, int* cycles,
               int k, int group, double lim, void* stream) {
  if (k <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (group) {
    case 1: launch_exp_group<T, 1>(v, sign, out, evals, steps, cycles, k, lim, st); break;
    case 4: launch_exp_group<T, 4>(v, sign, out, evals, steps, cycles, k, lim, st); break;
    case 8: launch_exp_group<T, 8>(v, sign, out, evals, steps, cycles, k, lim, st); break;
    case 16: launch_exp_group<T, 16>(v, sign, out, evals, steps, cycles, k, lim, st); break;
    case 32: launch_exp_group<T, 32>(v, sign, out, evals, steps, cycles, k, lim, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
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

template <typename T, int P, bool kWarp>
void launch_box_design(const void* v, const void* bl, const void* bu, void* out, int* iters,
                       int* cycles, int batch, int nb, int bound_stride, cudaStream_t stream) {
  const int blocks = kWarp ? (batch + kBoxWarps - 1) / kBoxWarps : batch;
  proj_box_kernel<T, P, kWarp><<<blocks, kWarp ? 32 * kBoxWarps : kBoxThreads, 0, stream>>>(
      (const T*)v, (const T*)bl, (const T*)bu, (T*)out, iters, cycles, batch, nb, bound_stride);
}

template <typename T>
int launch_box(const void* v, const void* bl, const void* bu, void* out, int* iters, int* cycles,
               int batch, int nb, int bound_stride, void* stream) {
  if (batch <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  // slots a thread needs, rounded up to a power of two
  const int warp_slots = (nb + 31) / 32;
  const int block_slots = (nb + kBoxThreads - 1) / kBoxThreads;
#define BOX(P, W) launch_box_design<T, P, W>(v, bl, bu, out, iters, cycles, batch, nb, bound_stride, st)
  if (warp_slots <= 1) BOX(1, true);
  else if (warp_slots <= 2) BOX(2, true);
  else if (warp_slots <= 4) BOX(4, true);
  else if (warp_slots <= 8) BOX(8, true);
  else if (warp_slots <= kBoxWarpSlots) BOX(kBoxWarpSlots, true);
  else if (block_slots <= 2) BOX(2, false);
  else if (block_slots <= 4) BOX(4, false);
  else BOX(8, false);  // past 2048 bounds the rest are read from memory each step
#undef BOX
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int proj_exp_f32(const void* v, const void* sign, void* out, int* evals, int* steps, int* cycles,
                 int k, int group, double explim, void* stream) {
  return launch_exp<float>(v, sign, out, evals, steps, cycles, k, group, explim, stream);
}
int proj_exp_f64(const void* v, const void* sign, void* out, int* evals, int* steps, int* cycles,
                 int k, int group, double explim, void* stream) {
  return launch_exp<double>(v, sign, out, evals, steps, cycles, k, group, explim, stream);
}
int proj_pow_f32(const void* v, const void* a, const void* sign, void* out, int* iters, int k,
                 void* stream) {
  return launch_pow<float>(v, a, sign, out, iters, k, stream);
}
int proj_pow_f64(const void* v, const void* a, const void* sign, void* out, int* iters, int k,
                 void* stream) {
  return launch_pow<double>(v, a, sign, out, iters, k, stream);
}
int proj_box_f32(const void* v, const void* bl, const void* bu, void* out, int* iters,
                 int* cycles, int batch, int nb, int bound_stride, void* stream) {
  return launch_box<float>(v, bl, bu, out, iters, cycles, batch, nb, bound_stride, stream);
}
int proj_box_f64(const void* v, const void* bl, const void* bu, void* out, int* iters,
                 int* cycles, int batch, int nb, int bound_stride, void* stream) {
  return launch_box<double>(v, bl, bu, out, iters, cycles, batch, nb, bound_stride, stream);
}

}  // extern "C"
