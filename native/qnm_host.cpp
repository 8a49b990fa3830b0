// qnm_host — native host-side BFGS maximizer.
//
// The framework's CPU-native runtime component: a zero-allocation
// (steady-state) BFGS maximizer with the same numerical contract as the JAX
// drivers and the reference library (chriselrod/QuasiNewtonMethods.jl,
// reference semantics at src/QuasiNewtonMethods.jl:237-292 — maximization,
// y = grad_old - grad_new, ascent direction +B^-1 grad, quadratic/cubic
// backtracking, in-band NaN/alpha==0 failure). Written from scratch in C++;
// the compiler auto-vectorizes the fused loops (-O3 -march=native), playing
// the role LoopVectorization plays for the reference.
//
// Why it exists in an accelerator framework:
//   * single low-latency solves: no XLA compile, ~100x less dispatch
//     overhead than any JIT path — this is what beats the reference's
//     330 us/solve headline benchmark on its own terms (CPU, n=60);
//   * an independent parity oracle for the JAX/Pallas numerics (different
//     compiler, different language, same algebra);
//   * host-side fallback where no accelerator exists.
//
// C ABI only (ctypes-friendly); no global state; one workspace per solve
// call, reusable across calls from the owning thread.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <new>
#include <thread>
#include <vector>

namespace {

// ----- status codes (must match quasinewtonmethods_jl_tpu.state.Status) ----
enum Status : int32_t {
  kRunning = 0,
  kConverged = 1,
  kMaxIterations = 2,
  kLinesearchFailure = 3,
  kNonfiniteValue = 4,
};

inline double nanmin(double a, double b) {
  // a < b ? a : (isnan(b) ? a : b)   [reference :152]
  return a < b ? a : (std::isnan(b) ? a : b);
}
inline double nanmax(double a, double b) {
  // a < b ? b : (isnan(a) ? b : a)   [reference :153]
  return a < b ? b : (std::isnan(a) ? b : a);
}

struct Workspace {
  // SIMD padding, the reference's L = align(P, vector_width) trick (:97):
  // every vector and every B column is padded to a multiple of 8 doubles
  // (one AVX-512 register), zero-filled, so the hot loops run full-width
  // with no remainder handling and 64-byte-aligned columns. Zero tails are
  // self-preserving through the update (tail products are 0 * 0).
  int n = 0;
  int L = 0;  // padded length / column stride
  double* buf = nullptr;  // single aligned slab: 7 vectors (L) + B (L*n)
  double *x_old, *x_new, *g_new, *g_old, *y, *s, *By, *B;

  bool resize(int n_) {
    if (n_ == n && buf) return true;
    std::free(buf);
    n = n_;
    L = (n_ + 7) & ~7;
    size_t vec = static_cast<size_t>(L);
    size_t total = 7 * vec + vec * static_cast<size_t>(n_);
    buf = static_cast<double*>(std::aligned_alloc(64, ((total * 8 + 63) / 64) * 64));
    if (!buf) return false;
    std::memset(buf, 0, total * 8);  // zero tails once; they stay zero
    x_old = buf;
    x_new = x_old + vec;
    g_new = x_new + vec;
    g_old = g_new + vec;
    y = g_old + vec;
    s = y + vec;
    By = s + vec;
    B = By + vec;
    return true;
  }
  ~Workspace() { std::free(buf); }
};

// objective callbacks: value, and value+gradient (gradient written in place)
typedef double (*value_fn)(const double* x, int32_t n, void* user);
typedef double (*value_grad_fn)(double* grad, const double* x, int32_t n,
                                void* user);

inline void identity(double* B, int n, int L) {
  std::memset(B, 0, sizeof(double) * L * n);
  for (int i = 0; i < n; ++i) B[static_cast<size_t>(i) * L + i] = 1.0;
}

// Fused rank-2 inverse-BFGS update + next direction; returns m = g'B_new g.
// Mirrors the reference's three fused loops (:36-67): (1) y and s'y,
// (2) By and y'By, (3) rank-2 update fused with d = B_new g and m.
// The new direction lands in w.y (the reference's s<->y swap, :268).
// restrict + omp simd reductions are what let the compiler emit the packed
// FMA code LoopVectorization emits for the reference (all workspace
// pointers come from one slab, so aliasing must be asserted away, and
// strict-FP reductions never auto-vectorize).
// L_ == 0 selects the runtime-L generic version; a compile-time L fully
// unrolls the 8..16-iteration inner loops (loop overhead dominates such
// short vector loops). The buffers are RESTRICT-QUALIFIED PARAMETERS, not
// restrict locals: gcc honors restrict on parameters but largely ignores it
// on locals derived from a struct, which measured 2.4x slower.
template <int L_>
double bfgs_update_impl(int n, int L_runtime, double* __restrict__ B,
                        const double* __restrict__ s, double* __restrict__ y,
                        double* __restrict__ By,
                        const double* __restrict__ g_new,
                        const double* __restrict__ g_old, bool h0_fresh) {
  const int L = L_ ? L_ : L_runtime;  // padded inner length, multiple of 8

  double sty = 0.0;
  double yty = 0.0;
#pragma omp simd reduction(+ : sty) reduction(+ : yty)
  for (int i = 0; i < L; ++i) {
    double yi = g_old[i] - g_new[i];
    sty += s[i] * yi;
    yty += yi * yi;
    y[i] = yi;
  }
  const double rho = 1.0 / sty;
  // H0 scaling of a fresh identity B (Nocedal 6.20; same rule as the JAX
  // drivers): B <- clip(sty/yty, 1e-3, 1e3) * B. B is exactly I here (fresh
  // means just-initialized or just-reset), so scaling the diagonal suffices.
  if (h0_fresh && sty > 0.0) {
    double gamma = sty / yty;
    gamma = gamma < 1e-3 ? 1e-3 : (gamma > 1e3 ? 1e3 : gamma);
    for (int i = 0; i < n; ++i) B[static_cast<size_t>(i) * L + i] = gamma;
  }

  // B⁻¹y via VERTICAL accumulation over columns (valid by symmetry):
  // By[:] = sum_c y[c] * B[:,c]. Unlike the per-column dot form, this emits
  // zero horizontal reductions inside the column loop — with L = 64 the
  // short per-column dots would pay a horizontal-add tail 60 times per
  // pass, which measured 3.3x slower than this form.
#pragma omp simd
  for (int r = 0; r < L; ++r) By[r] = 0.0;
  for (int c = 0; c < n; ++c) {
    const double* __restrict__ Bc = B + static_cast<size_t>(c) * L;
    const double yc = y[c];
#pragma omp simd
    for (int r = 0; r < L; ++r) By[r] += yc * Bc[r];
  }
  double ytBy = 0.0;
#pragma omp simd reduction(+ : ytBy)
  for (int r = 0; r < L; ++r) ytBy += By[r] * y[r];
  const double c1 = (1.0 + ytBy * rho) * rho;
#pragma omp simd
  for (int r = 0; r < L; ++r) By[r] *= rho;  // scaled B⁻¹y (reference :50)

  // Fused rank-2 update + next direction, one pass over B. d = B_new g is
  // accumulated vertically (d[:] += g[c] * B_new[:,c], again by symmetry)
  // into the y buffer, which is dead after the By pass — the direction
  // landing in y is exactly the reference's layout (:65 then the swap :268).
#pragma omp simd
  for (int r = 0; r < L; ++r) y[r] = 0.0;
  for (int c = 0; c < n; ++c) {
    double* __restrict__ Bc = B + static_cast<size_t>(c) * L;
    const double sc = s[c], gc = g_new[c];
    const double co = c1 * sc - By[c];
#pragma omp simd
    for (int r = 0; r < L; ++r) {
      const double v = Bc[r] + co * s[r] - sc * By[r];
      Bc[r] = v;
      y[r] += gc * v;
    }
  }
  double m = 0.0;
#pragma omp simd reduction(+ : m)
  for (int r = 0; r < L; ++r) m += y[r] * g_new[r];
  return m;
}

// Dispatch to an L-specialized instantiation (L <= 128 covers the dense-B
// sweet spot; larger problems amortize loop overhead anyway).
double bfgs_update(Workspace& w, bool h0_fresh) {
#define QNM_CASE(LV)                                                       \
  case LV:                                                                 \
    return bfgs_update_impl<LV>(w.n, w.L, w.B, w.s, w.y, w.By, w.g_new,    \
                                w.g_old, h0_fresh)
  switch (w.L) {
    QNM_CASE(8);
    QNM_CASE(16);
    QNM_CASE(24);
    QNM_CASE(32);
    QNM_CASE(40);
    QNM_CASE(48);
    QNM_CASE(56);
    QNM_CASE(64);
    QNM_CASE(96);
    QNM_CASE(128);
    default:
      return bfgs_update_impl<0>(w.n, w.L, w.B, w.s, w.y, w.By, w.g_new,
                                 w.g_old, h0_fresh);
  }
#undef QNM_CASE
}

// Backtracking line search (maximization; reference :165-232). Returns the
// accepted alpha, 0.0 on failure. Shared by the BFGS and L-BFGS drivers
// (explicit buffers instead of a workspace so both state layouts fit).
double linesearch(int n, int L, double* x_new_buf, const double* x_old_buf,
                  value_fn f, void* user, double f0, double m,
                  int order, double c1p, double rho_hi, double rho_lo,
                  int iterations, const double* d, int64_t* n_fev) {
  const double sqrttol = 1.0 / 67108864.0;  // 2^-26, f64 (reference :155)
  const double eps = std::numeric_limits<double>::epsilon();

  auto step = [&](double a) {
    double* __restrict__ xn = x_new_buf;
    const double* __restrict__ xo = x_old_buf;
#pragma omp simd
    for (int i = 0; i < L; ++i) xn[i] = xo[i] + a * d[i];
    ++*n_fev;
    return f(x_new_buf, n, user);
  };

  double a1 = 1.0, a2 = 1.0;
  double fx0 = f0, fx1 = step(a2);

  // finite-search phase: halve up to significand_bits(f64) = 52 times
  for (int it = 0; !std::isfinite(fx1) && it < 52; ++it) {
    a1 = a2;
    a2 = 0.5 * a2;
    fx1 = step(a2);
  }

  int iteration = 0;
  while (!(fx1 >= f0 + a2 * c1p * m)) {
    if (++iteration > iterations) return 0.0;  // in-band failure (:193)
    double at;
    const double quad = -(m * a2 * a2) / (2.0 * (fx1 - f0 - m * a2));
    if (order == 2 || iteration == 1) {
      at = quad;
    } else {
      const double denom = 1.0 / (a1 * a1 * a2 * a2 * (a2 - a1));
      const double r1 = fx1 - f0 - m * a2;
      const double r0 = fx0 - f0 - m * a1;
      const double a = (a1 * a1 * r1 - a2 * a2 * r0) * denom;
      const double b = (-a1 * a1 * a1 * r1 + a2 * a2 * a2 * r0) * denom;
      if (std::fabs(a) <= eps + sqrttol * std::fabs(a)) {
        at = m / (2.0 * b);
      } else {
        const double disc = nanmax(b * b - 3.0 * a * m, 0.0);
        at = (std::sqrt(disc) + b) / (-3.0 * a);
      }
    }
    a1 = a2;
    at = nanmin(at, a2 * rho_hi);
    a2 = nanmax(at, a2 * rho_lo);
    fx0 = fx1;
    fx1 = step(a2);
  }
  return a2;
}

// ----- L-BFGS (limited memory) ---------------------------------------------
// Native counterpart of the JAX scalar L-BFGS driver
// (quasinewtonmethods_jl_tpu/lbfgs_solve.py / ops/lbfgs.py): cautious ring
// push (pairs with s'y <= 0 skipped), Barzilai-Borwein gamma as H0, classic
// two-loop recursion producing the ascent direction, and the hist = 0 /
// m <= 0 steepest-ascent reset. The ring is genuinely circular here (cheap
// integer indexing on the host — no shifting, no rotation).

struct LWorkspace {
  int n = 0, L = 0, m = 0;
  double* buf = nullptr;  // slab: 6 vectors (L) + S (m*L) + Y (m*L) + 2m
  double *x_old, *x_new, *g_new, *g_old, *d, *step, *S, *Y, *rho, *alpha;

  bool resize(int n_, int m_) {
    if (n_ == n && m_ == m && buf) return true;
    std::free(buf);
    n = n_;
    m = m_;
    L = (n_ + 7) & ~7;
    size_t vec = static_cast<size_t>(L);
    size_t total = 6 * vec + 2 * vec * static_cast<size_t>(m_) + 2 * m_;
    buf = static_cast<double*>(
        std::aligned_alloc(64, ((total * 8 + 63) / 64) * 64));
    if (!buf) return false;
    std::memset(buf, 0, total * 8);
    x_old = buf;
    x_new = x_old + vec;
    g_new = x_new + vec;
    g_old = g_new + vec;
    d = g_old + vec;
    step = d + vec;
    S = step + vec;
    Y = S + vec * m_;
    rho = Y + vec * m_;
    alpha = rho + m_;
    return true;
  }
  ~LWorkspace() { std::free(buf); }
};

// Two-loop recursion over the circular ring; writes the ascent direction
// into w.d and returns m = d'g. Slot (head - 1 - j) mod m is the j-th
// newest pair.
double lbfgs_direction(LWorkspace& w, int hist, int head, double gamma) {
  const int L = w.L, mh = w.m;
  double* __restrict__ q = w.d;
  const double* __restrict__ g = w.g_new;
#pragma omp simd
  for (int i = 0; i < L; ++i) q[i] = g[i];

  for (int j = 0; j < hist; ++j) {
    const int slot = ((head - 1 - j) % mh + mh) % mh;
    const double* __restrict__ Si = w.S + static_cast<size_t>(slot) * L;
    const double* __restrict__ Yi = w.Y + static_cast<size_t>(slot) * L;
    double sq = 0.0;
#pragma omp simd reduction(+ : sq)
    for (int i = 0; i < L; ++i) sq += Si[i] * q[i];
    const double a = w.rho[slot] * sq;
    w.alpha[slot] = a;
#pragma omp simd
    for (int i = 0; i < L; ++i) q[i] -= a * Yi[i];
  }
#pragma omp simd
  for (int i = 0; i < L; ++i) q[i] *= gamma;
  for (int j = hist - 1; j >= 0; --j) {  // oldest..newest
    const int slot = ((head - 1 - j) % mh + mh) % mh;
    const double* __restrict__ Si = w.S + static_cast<size_t>(slot) * L;
    const double* __restrict__ Yi = w.Y + static_cast<size_t>(slot) * L;
    double yq = 0.0;
#pragma omp simd reduction(+ : yq)
    for (int i = 0; i < L; ++i) yq += Yi[i] * q[i];
    const double b = w.rho[slot] * yq;
    const double coef = w.alpha[slot] - b;
#pragma omp simd
    for (int i = 0; i < L; ++i) q[i] += coef * Si[i];
  }
  double mdir = 0.0;
#pragma omp simd reduction(+ : mdir)
  for (int i = 0; i < L; ++i) mdir += q[i] * g[i];
  return mdir;
}

}  // namespace

extern "C" {

// Full solve. Returns the maximized log-density on convergence, NaN on any
// failure (the reference's return contract, :261/:291). Outputs: out_x and
// out_grad (length n), out_status / out_iterations / out_nfev / out_ngev.
double qnm_bfgs_optimize(value_grad_fn fg, value_fn f, void* user, int32_t n,
                         const double* x0, int32_t order, double ls_c1,
                         double rho_hi, double rho_lo, int32_t ls_iterations,
                         double tol, int32_t max_iterations, int32_t h0_scale,
                         double* out_x, double* out_grad, int32_t* out_status,
                         int32_t* out_iterations, int64_t* out_nfev,
                         int64_t* out_ngev) {
  thread_local Workspace w;
  const double NaN = std::numeric_limits<double>::quiet_NaN();
  *out_status = kMaxIterations;
  *out_iterations = 0;
  *out_nfev = 0;
  *out_ngev = 0;
  if (!w.resize(n)) {
    *out_status = kNonfiniteValue;
    return NaN;
  }
  std::memcpy(w.x_old, x0, sizeof(double) * n);
  identity(w.B, n, w.L);

  double result = NaN;
  bool fresh = true;  // B is an unscaled fresh identity

  for (int32_t k = 0; k < max_iterations; ++k) {
    const double f0 = fg(w.g_new, w.x_old, n, user);
    ++*out_nfev;
    ++*out_ngev;
    if (!std::isfinite(f0)) {
      *out_status = kNonfiniteValue;
      break;
    }
    double gmax = 0.0;
    {
      const double* __restrict__ gv = w.g_new;
#pragma omp simd reduction(max : gmax)
      for (int i = 0; i < n; ++i) gmax = std::fmax(gmax, std::fabs(gv[i]));
    }
    if (gmax < tol) {
      *out_status = kConverged;
      result = f0;
      break;
    }
    double m;
    if (k == 0) {
      m = -1.0;  // sentinel forces the steepest-ascent branch (:263-264)
    } else {
      m = bfgs_update(w, h0_scale != 0 && fresh);
      fresh = false;
      std::swap(w.s, w.y);  // direction lands in s (:268)
    }
    if (m <= 0.0) {  // identity reset + steepest ascent (:272-280)
      identity(w.B, n, w.L);
      fresh = true;
      m = 0.0;
      for (int i = 0; i < n; ++i) {
        const double gi = w.g_new[i];
        w.s[i] = gi;
        m += gi * gi;
      }
    }
    const double alpha = linesearch(w.n, w.L, w.x_new, w.x_old, f, user, f0,
                                    m, order, ls_c1, rho_hi, rho_lo,
                                    ls_iterations, w.s, out_nfev);
    if (alpha == 0.0) {
      *out_status = kLinesearchFailure;
      break;
    }
    {
      double* __restrict__ sv = w.s;
      double* __restrict__ xo = w.x_old;
#pragma omp simd
      for (int i = 0; i < w.L; ++i) {
        const double si = alpha * sv[i];
        sv[i] = si;        // accepted step (reference update_state!, :21-27)
        xo[i] += si;
      }
    }
    std::swap(w.g_old, w.g_new);
    ++*out_iterations;
  }
  std::memcpy(out_x, w.x_old, sizeof(double) * n);
  // Break paths exit before their iteration's g_old<->g_new swap, so g_new
  // holds the gradient evaluated at the exit iterate. The MAX_ITERATIONS
  // path falls off the for-loop AFTER the final swap: there the freshest
  // gradient (one iterate back from out_x — the last one ever evaluated)
  // is in g_old, and g_new would be two evaluations stale.
  std::memcpy(out_grad,
              *out_status == kMaxIterations ? w.g_old : w.g_new,
              sizeof(double) * n);
  return result;
}

// Full L-BFGS solve (history = m pairs). Same contract as qnm_bfgs_optimize:
// maximized value on convergence, NaN on any failure; in-band status codes.
double qnm_lbfgs_optimize(value_grad_fn fg, value_fn f, void* user, int32_t n,
                          const double* x0, int32_t history, int32_t order,
                          double ls_c1, double rho_hi, double rho_lo,
                          int32_t ls_iterations, double tol,
                          int32_t max_iterations, double* out_x,
                          double* out_grad, int32_t* out_status,
                          int32_t* out_iterations, int64_t* out_nfev,
                          int64_t* out_ngev) {
  thread_local LWorkspace w;
  const double NaN = std::numeric_limits<double>::quiet_NaN();
  *out_status = kMaxIterations;
  *out_iterations = 0;
  *out_nfev = 0;
  *out_ngev = 0;
  if (history < 1 || !w.resize(n, history)) {
    *out_status = kNonfiniteValue;
    return NaN;
  }
  // step/g_old start zeroed: the first iteration's candidate pair has
  // s'y = 0 and is rejected by the cautious push, matching the JAX init.
  std::memset(w.step, 0, sizeof(double) * w.L);
  std::memset(w.g_old, 0, sizeof(double) * w.L);
  std::memset(w.g_new, 0, sizeof(double) * w.L);
  std::memcpy(w.x_old, x0, sizeof(double) * n);

  int hist = 0, head = 0;
  double gamma = 1.0;
  double result = NaN;

  for (int32_t k = 0; k < max_iterations; ++k) {
    const double f0 = fg(w.g_new, w.x_old, n, user);
    ++*out_nfev;
    ++*out_ngev;
    if (!std::isfinite(f0)) {
      *out_status = kNonfiniteValue;
      break;
    }
    double gmax = 0.0;
    {
      const double* __restrict__ gv = w.g_new;
#pragma omp simd reduction(max : gmax)
      for (int i = 0; i < n; ++i) gmax = std::fmax(gmax, std::fabs(gv[i]));
    }
    if (gmax < tol) {
      *out_status = kConverged;
      result = f0;
      break;
    }

    // cautious push of the previous accepted step's pair (lbfgs_push)
    {
      double sty = 0.0, yty = 0.0;
      const double* __restrict__ sv = w.step;
      const double* __restrict__ go = w.g_old;
      const double* __restrict__ gn = w.g_new;
#pragma omp simd reduction(+ : sty) reduction(+ : yty)
      for (int i = 0; i < w.L; ++i) {
        const double yi = go[i] - gn[i];
        sty += sv[i] * yi;
        yty += yi * yi;
      }
      if (sty > 0.0) {
        double* __restrict__ Ss = w.S + static_cast<size_t>(head) * w.L;
        double* __restrict__ Ys = w.Y + static_cast<size_t>(head) * w.L;
#pragma omp simd
        for (int i = 0; i < w.L; ++i) {
          Ss[i] = sv[i];
          Ys[i] = go[i] - gn[i];
        }
        w.rho[head] = 1.0 / sty;
        head = (head + 1) % w.m;
        hist = hist < w.m ? hist + 1 : w.m;
        gamma = sty / yty;
      }
    }

    double m = lbfgs_direction(w, hist, head, gamma);
    if (m <= 0.0) {  // limited-memory analog of the identity reset
      hist = 0;
      gamma = 1.0;
      m = 0.0;
      for (int i = 0; i < n; ++i) {
        const double gi = w.g_new[i];
        w.d[i] = gi;
        m += gi * gi;
      }
      for (int i = n; i < w.L; ++i) w.d[i] = 0.0;
    }

    const double alpha = linesearch(w.n, w.L, w.x_new, w.x_old, f, user, f0,
                                    m, order, ls_c1, rho_hi, rho_lo,
                                    ls_iterations, w.d, out_nfev);
    if (alpha == 0.0) {
      *out_status = kLinesearchFailure;
      break;
    }
    {
      double* __restrict__ sv = w.step;
      double* __restrict__ dv = w.d;
      double* __restrict__ xo = w.x_old;
#pragma omp simd
      for (int i = 0; i < w.L; ++i) {
        const double si = alpha * dv[i];
        sv[i] = si;
        xo[i] += si;
      }
    }
    std::swap(w.g_old, w.g_new);
    ++*out_iterations;
  }
  std::memcpy(out_x, w.x_old, sizeof(double) * n);
  // same freshest-gradient bookkeeping as qnm_bfgs_optimize
  std::memcpy(out_grad,
              *out_status == kMaxIterations ? w.g_old : w.g_new,
              sizeof(double) * n);
  return result;
}

// ----- built-in objectives (benchmark + parity fixtures) --------------------

// Extended Rosenbrock log-density (maximization form), matching the
// reference fixture (test/runtests.jl:4-33) including the odd-n tail.
double qnm_rosenbrock_value(const double* __restrict__ x, int32_t n, void*) {
  const int32_t half = n >> 1;
  double s = 0.0;
#pragma omp simd reduction(- : s)
  for (int32_t i = 0; i < half; ++i) {
    const double r = x[i + half] - x[i] * x[i];
    const double q = 1.0 - x[i];
    s -= 100.0 * r * r + q * q;
  }
  if (n & 1) {
    const double delta = 1.0 - x[n - 1];
    s -= delta * delta;
  }
  return s;
}

double qnm_rosenbrock_value_grad(double* __restrict__ g,
                                 const double* __restrict__ x, int32_t n,
                                 void*) {
  const int32_t half = n >> 1;
  double s = 0.0;
#pragma omp simd reduction(- : s)
  for (int32_t i = 0; i < half; ++i) {
    const double r = x[i + half] - x[i] * x[i];
    const double q = 1.0 - x[i];
    s -= 100.0 * r * r + q * q;
    g[i] = 400.0 * r * x[i] + 2.0 * q;
    g[i + half] = -200.0 * r;
  }
  if (n & 1) {
    const double delta = 1.0 - x[n - 1];
    s -= delta * delta;
    g[n - 1] = 2.0 * delta;
  }
  return s;
}

// Convenience: full native solve on the built-in Rosenbrock (used by the
// benchmark harness so no Python callback crosses the hot path).
double qnm_bfgs_optimize_rosenbrock(int32_t n, const double* x0, int32_t order,
                                    double tol, int32_t max_iterations,
                                    int32_t h0_scale, double* out_x,
                                    double* out_grad, int32_t* out_status,
                                    int32_t* out_iterations, int64_t* out_nfev,
                                    int64_t* out_ngev) {
  return qnm_bfgs_optimize(&qnm_rosenbrock_value_grad, &qnm_rosenbrock_value,
                           nullptr, n, x0, order, 1e-4, 0.5, 0.1, 1000, tol,
                           max_iterations, h0_scale, out_x, out_grad,
                           out_status, out_iterations, out_nfev, out_ngev);
}

double qnm_lbfgs_optimize_rosenbrock(int32_t n, const double* x0,
                                     int32_t history, int32_t order,
                                     double tol, int32_t max_iterations,
                                     double* out_x, double* out_grad,
                                     int32_t* out_status,
                                     int32_t* out_iterations,
                                     int64_t* out_nfev, int64_t* out_ngev) {
  return qnm_lbfgs_optimize(&qnm_rosenbrock_value_grad, &qnm_rosenbrock_value,
                            nullptr, n, x0, history, order, 1e-4, 0.5, 0.1,
                            1000, tol, max_iterations, out_x, out_grad,
                            out_status, out_iterations, out_nfev, out_ngev);
}

// ----- nonlinear CG (memoryless quasi-Newton) --------------------------------
// Native counterpart of the JAX CG fleet engine
// (quasinewtonmethods_jl_tpu/cg_solve.py): Hager-Zhang / PR+ / FR / DY
// betas in the maximization convention, in-band steepest resets, Powell
// restarts for fr/pr, the Nocedal-Wright warm-start scale riding the
// direction, and the weak-Wolfe line search with the Hager-Zhang
// approximate acceptance + slope-driven interval update (the endgame a
// linear-convergence engine needs below the fp resolution floor —
// measured in cg_solve.py: ordinary Armijo stalls at max|grad| ~ 1e-6 on
// stiff quadratics, approx certifies 1e-8).

enum CGMethod : int32_t { kHZ = 0, kPR = 1, kFR = 2, kDY = 3 };

struct CGWorkspace {
  int n = 0, L = 0;
  double* buf = nullptr;  // 7 vectors of length L
  double *x_old, *x_trial, *g_new, *g_old, *g_trial, *d, *d_ls;

  bool resize(int n_) {
    if (n_ == n && buf) return true;
    std::free(buf);
    n = n_;
    L = (n_ + 7) & ~7;
    size_t vec = static_cast<size_t>(L);
    buf = static_cast<double*>(
        std::aligned_alloc(64, ((7 * vec * 8 + 63) / 64) * 64));
    if (!buf) return false;
    std::memset(buf, 0, 7 * vec * 8);
    x_old = buf;
    x_trial = x_old + vec;
    g_new = x_trial + vec;
    g_old = g_new + vec;
    g_trial = g_old + vec;
    d = g_trial + vec;
    d_ls = d + vec;
    return true;
  }
  ~CGWorkspace() { std::free(buf); }
};

inline double dot_n(const double* __restrict__ a, const double* __restrict__ b,
                    int n) {
  double s = 0.0;
#pragma omp simd reduction(+ : s)
  for (int i = 0; i < n; ++i) s += a[i] * b[i];
  return s;
}

// Weak-Wolfe search along w.d_ls (maximization form; cg_solve/ops/wolfe.py
// semantics): returns the accepted alpha or 0.0 in-band. Evaluates
// value+grad at w.x_trial into w.g_trial; fa/sa returned via refs.
double wolfe_search(CGWorkspace& w, value_grad_fn fg, void* user, double f0,
                    double m, double c1, double c2, int iterations,
                    bool approx, double approx_eps, int64_t* n_fev,
                    int64_t* n_gev) {
  if (!std::isfinite(m) || !std::isfinite(f0)) return 0.0;  // doomed
  const double inf = std::numeric_limits<double>::infinity();
  const double NaN = std::numeric_limits<double>::quiet_NaN();

  auto phi = [&](double a, double& fa, double& sa) {
    const double* __restrict__ xo = w.x_old;
    const double* __restrict__ dl = w.d_ls;
    double* __restrict__ xt = w.x_trial;
#pragma omp simd
    for (int i = 0; i < w.L; ++i) xt[i] = xo[i] + a * dl[i];
    fa = fg(w.g_trial, w.x_trial, w.n, user);
    sa = dot_n(w.g_trial, w.d_ls, w.n);
    ++*n_fev;
    ++*n_gev;
  };

  auto accepts = [&](double a, double fa, double sa) {
    const bool armijo = fa >= f0 + c1 * a * m;
    const bool curv = sa <= c2 * m;
    bool ok = armijo && curv;
    if (approx) {
      const bool aw = (sa >= (2.0 * c1 - 1.0) * m) && curv &&
                      (fa >= f0 - approx_eps * std::fabs(f0));
      ok = ok || aw;
    }
    return ok;
  };

  double lo = 0.0, flo = f0, slo = m;
  double hi = inf, fhi = NaN, shi = NaN;
  double a = 1.0, fa, sa;
  phi(a, fa, sa);

  for (int it = 0; !accepts(a, fa, sa) && it < iterations; ++it) {
    bool shrink;
    if (approx) {
      // Hager-Zhang slope-driven update (CG_DESCENT §4; see
      // ops/wolfe.py for the measured Armijo-bracket failure mode)
      const double bar = f0 - approx_eps * std::fabs(f0);
      const bool bad = !(std::isfinite(fa) && std::isfinite(sa));
      shrink = (sa <= 0.0) || (fa < bar) || bad;
    } else {
      shrink = !(fa >= f0 + c1 * a * m);  // NaN fails Armijo -> shrink
    }
    if (shrink) {
      hi = a;
      fhi = fa;
      shi = sa;
    } else {
      lo = a;
      flo = fa;
      slo = sa;
    }
    if (std::isinf(hi)) {
      a = 2.0 * lo;
    } else {
      // safeguarded Hermite-cubic maximizer (wolfe_propose)
      const double wid = hi - lo;
      const double mid = 0.5 * (lo + hi);
      const double d1 = -(slo + shi) + 3.0 * (flo - fhi) / (lo - hi);
      const double disc = d1 * d1 - slo * shi;
      if (disc >= 0.0) {
        const double d2 = std::sqrt(disc);
        double at = hi - wid * (-shi + d2 - d1) / (-shi + slo + 2.0 * d2);
        at = std::fmin(std::fmax(at, lo + 0.1 * wid), hi - 0.1 * wid);
        a = std::isfinite(at) ? at : mid;
      } else {
        a = mid;
      }
    }
    phi(a, fa, sa);
  }
  return accepts(a, fa, sa) ? a : 0.0;
}

// Full nonlinear-CG solve. Same contract as qnm_bfgs_optimize: maximized
// value on convergence, NaN on any failure, in-band status codes.
// method: 0 = hz, 1 = pr, 2 = fr, 3 = dy. approx_wolfe != 0 enables the
// Hager-Zhang approximate acceptance (the JAX engine's default).
double qnm_cg_optimize(value_grad_fn fg, void* user, int32_t n,
                       const double* x0, int32_t method, double ls_c1,
                       double ls_c2, int32_t ls_iterations,
                       int32_t approx_wolfe, double approx_eps,
                       double restart_nu, double tol,
                       int32_t max_iterations, double* out_x,
                       double* out_grad, int32_t* out_status,
                       int32_t* out_iterations, int64_t* out_nfev,
                       int64_t* out_ngev) {
  thread_local CGWorkspace w;
  const double NaN = std::numeric_limits<double>::quiet_NaN();
  *out_status = kMaxIterations;
  *out_iterations = 0;
  *out_nfev = 0;
  *out_ngev = 0;
  if (method < kHZ || method > kDY || !w.resize(n)) {
    *out_status = kNonfiniteValue;
    return NaN;
  }
  std::memcpy(w.x_old, x0, sizeof(double) * n);
  std::memset(w.g_old, 0, sizeof(double) * w.L);
  std::memset(w.d, 0, sizeof(double) * w.L);

  double result = NaN;
  double m_prev = 0.0, t_prev = 0.0;

  for (int32_t k = 0; k < max_iterations; ++k) {
    const double f0 = fg(w.g_new, w.x_old, n, user);
    ++*out_nfev;
    ++*out_ngev;
    if (!std::isfinite(f0)) {
      *out_status = kNonfiniteValue;
      break;
    }
    double gmax = 0.0;
    {
      const double* __restrict__ gv = w.g_new;
#pragma omp simd reduction(max : gmax)
      for (int i = 0; i < n; ++i) gmax = std::fmax(gmax, std::fabs(gv[i]));
    }
    if (gmax < tol) {
      *out_status = kConverged;
      result = f0;
      break;
    }

    const double gg = dot_n(w.g_new, w.g_new, n);
    double beta = 0.0;
    bool powell = false;
    if (k > 0) {
      const double gg_old = dot_n(w.g_old, w.g_old, n);
      const double gdotgold = dot_n(w.g_new, w.g_old, n);
      switch (method) {
        case kFR:
          beta = gg / gg_old;
          powell = std::fabs(gdotgold) > restart_nu * gg;
          break;
        case kPR:
          beta = std::fmax(0.0, (gg - gdotgold) / gg_old);
          powell = std::fabs(gdotgold) > restart_nu * gg;
          break;
        case kDY: {
          double dy = 0.0;
          const double* __restrict__ dv = w.d;
          const double* __restrict__ go = w.g_old;
          const double* __restrict__ gn = w.g_new;
#pragma omp simd reduction(+ : dy)
          for (int i = 0; i < n; ++i) dy += dv[i] * (go[i] - gn[i]);
          beta = gg / dy;
          break;
        }
        case kHZ:
        default: {
          double dy = 0.0, dg = 0.0, yy = 0.0, yg = 0.0, dd = 0.0;
          const double* __restrict__ dv = w.d;
          const double* __restrict__ go = w.g_old;
          const double* __restrict__ gn = w.g_new;
#pragma omp simd reduction(+ : dy) reduction(+ : dg) reduction(+ : yy) \
    reduction(+ : yg) reduction(+ : dd)
          for (int i = 0; i < n; ++i) {
            const double yi = go[i] - gn[i];
            dy += dv[i] * yi;
            dg += dv[i] * gn[i];
            yy += yi * yi;
            yg += yi * gn[i];
            dd += dv[i] * dv[i];
          }
          beta = (2.0 * dg * yy / dy - yg) / dy;
          const double eta_k =
              -1.0 / (std::sqrt(dd) * std::fmin(0.01, std::sqrt(gg_old)));
          beta = std::fmax(beta, eta_k);
          break;
        }
      }
    }

    // candidate direction + in-band steepest reset
    double m;
    {
      double* __restrict__ dv = w.d;
      const double* __restrict__ gn = w.g_new;
      double md = 0.0;
#pragma omp simd reduction(+ : md)
      for (int i = 0; i < w.L; ++i) {
        const double di = gn[i] + beta * dv[i];
        dv[i] = di;
        md += di * gn[i];
      }
      m = md;
      const bool fresh = (k == 0);
      if (!std::isfinite(m) || m <= 0.0 || fresh || powell) {
#pragma omp simd
        for (int i = 0; i < w.L; ++i) dv[i] = gn[i];
        m = gg;
      }
    }

    // warm-start scale (Nocedal-Wright first-order match; cg_solve.py)
    double t = t_prev * m_prev / m;
    if (m_prev == 0.0 || !std::isfinite(t) || t <= 0.0) {
      t = 1.0 / std::fmax(1.0, std::sqrt(gg));
    }
    t = std::fmin(std::fmax(t, 1e-12), 1e12);
    {
      double* __restrict__ dl = w.d_ls;
      const double* __restrict__ dv = w.d;
#pragma omp simd
      for (int i = 0; i < w.L; ++i) dl[i] = t * dv[i];
    }

    const double alpha =
        wolfe_search(w, fg, user, f0, t * m, ls_c1, ls_c2, ls_iterations,
                     approx_wolfe != 0, approx_eps, out_nfev, out_ngev);
    if (alpha == 0.0) {
      *out_status = kLinesearchFailure;
      break;
    }
    {
      double* __restrict__ xo = w.x_old;
      const double* __restrict__ dl = w.d_ls;
#pragma omp simd
      for (int i = 0; i < w.L; ++i) xo[i] += alpha * dl[i];
    }
    m_prev = m;
    t_prev = alpha * t;
    std::swap(w.g_old, w.g_new);
    ++*out_iterations;
  }
  std::memcpy(out_x, w.x_old, sizeof(double) * n);
  // same freshest-gradient bookkeeping as qnm_bfgs_optimize
  std::memcpy(out_grad,
              *out_status == kMaxIterations ? w.g_old : w.g_new,
              sizeof(double) * n);
  return result;
}

double qnm_cg_optimize_rosenbrock(int32_t n, const double* x0,
                                  int32_t method, double tol,
                                  int32_t max_iterations, double* out_x,
                                  double* out_grad, int32_t* out_status,
                                  int32_t* out_iterations,
                                  int64_t* out_nfev, int64_t* out_ngev) {
  return qnm_cg_optimize(&qnm_rosenbrock_value_grad, nullptr, n, x0, method,
                         1e-4, 0.9, 50, 1, 1e-6, 0.2, tol, max_iterations,
                         out_x, out_grad, out_status, out_iterations,
                         out_nfev, out_ngev);
}

// ----- threaded fleet drivers ------------------------------------------------
// The native analog of the reference's intended multi-thread usage pattern
// (PtrBFGSState, src/QuasiNewtonMethods.jl:117-121 + README.md:14: one
// self-contained zero-allocation state per thread, many independent solves
// side by side). Lanes are pulled from an atomic counter by a pool of
// std::threads; each thread's solves reuse its own thread_local workspace,
// so the steady state allocates nothing. Per-lane outputs land in
// caller-provided arrays (row i of the (batch, n) layouts).
//
// Callback contract: fg/f must be REENTRANT — the built-in objectives are;
// a Python (ctypes) callback serializes every evaluation on the GIL and
// turns the pool into an expensive single thread. Use n_threads = 1 for
// Python objectives, or point fg/f at native code for real host
// parallelism. n_threads <= 0 selects std::thread::hardware_concurrency().
// Returns the number of CONVERGED lanes.

int32_t qnm_bfgs_optimize_batch(
    value_grad_fn fg, value_fn f, void* user, int32_t n, int32_t batch,
    const double* x0s, int32_t order, double ls_c1, double rho_hi,
    double rho_lo, int32_t ls_iterations, double tol,
    int32_t max_iterations, int32_t h0_scale, int32_t n_threads,
    double* out_f, double* out_x, double* out_grad, int32_t* out_status,
    int32_t* out_iterations, int64_t* out_nfev, int64_t* out_ngev) {
  if (n_threads <= 0) {
    n_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  if (n_threads > batch) n_threads = batch;
  std::atomic<int32_t> next{0};
  std::atomic<int32_t> converged{0};

  auto worker = [&]() {
    int32_t local_conv = 0;
    for (;;) {
      const int32_t i = next.fetch_add(1, std::memory_order_relaxed);
      if (i >= batch) break;
      const size_t off = static_cast<size_t>(i) * n;
      out_f[i] = qnm_bfgs_optimize(
          fg, f, user, n, x0s + off, order, ls_c1, rho_hi, rho_lo,
          ls_iterations, tol, max_iterations, h0_scale, out_x + off,
          out_grad + off, out_status + i, out_iterations + i, out_nfev + i,
          out_ngev + i);
      if (out_status[i] == kConverged) ++local_conv;
    }
    converged.fetch_add(local_conv, std::memory_order_relaxed);
  };

  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int32_t t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return converged.load();
}

int32_t qnm_lbfgs_optimize_batch(
    value_grad_fn fg, value_fn f, void* user, int32_t n, int32_t batch,
    const double* x0s, int32_t history, int32_t order, double ls_c1,
    double rho_hi, double rho_lo, int32_t ls_iterations, double tol,
    int32_t max_iterations, int32_t n_threads, double* out_f, double* out_x,
    double* out_grad, int32_t* out_status, int32_t* out_iterations,
    int64_t* out_nfev, int64_t* out_ngev) {
  if (n_threads <= 0) {
    n_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  if (n_threads > batch) n_threads = batch;
  std::atomic<int32_t> next{0};
  std::atomic<int32_t> converged{0};

  auto worker = [&]() {
    int32_t local_conv = 0;
    for (;;) {
      const int32_t i = next.fetch_add(1, std::memory_order_relaxed);
      if (i >= batch) break;
      const size_t off = static_cast<size_t>(i) * n;
      out_f[i] = qnm_lbfgs_optimize(
          fg, f, user, n, x0s + off, history, order, ls_c1, rho_hi, rho_lo,
          ls_iterations, tol, max_iterations, out_x + off, out_grad + off,
          out_status + i, out_iterations + i, out_nfev + i, out_ngev + i);
      if (out_status[i] == kConverged) ++local_conv;
    }
    converged.fetch_add(local_conv, std::memory_order_relaxed);
  };

  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int32_t t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return converged.load();
}

// ---------------------------------------------------------------------
// Constrained optimization: PHR augmented Lagrangian over the native
// engines (the host counterpart of constrained.py's scalar driver —
// maximize f s.t. eq(x) = 0, ineq(x) >= 0; same multiplier updates,
// violation measure, rho schedule, and in-band contracts).
//
// Constraint callbacks: `constraint_fn` writes the m constraint values;
// `constraint_vjp_fn` ACCUMULATES J(x)^T w into accum (length n) — the
// caller supplies the weighted-Jacobian-transpose product (trivial for
// linear constraints; exactly the VJP an AD system would produce).
// ---------------------------------------------------------------------

typedef void (*constraint_fn)(double* out, const double* x, int32_t n,
                              void* user);
typedef void (*constraint_vjp_fn)(double* accum, const double* x,
                                  const double* w, int32_t n, void* user);

namespace {

struct AugCtx {
  value_grad_fn fg;
  value_fn f;
  void* user;
  constraint_fn eq;
  constraint_vjp_fn eq_vjp;
  int32_t m_eq;
  constraint_fn ineq;
  constraint_vjp_fn in_vjp;
  int32_t m_in;
  const double* lam;
  const double* mu;
  double rho;
  double* hbuf;  // m_eq scratch
  double* cbuf;  // m_in scratch
  double* wbuf;  // max(m_eq, m_in) scratch for vjp weights
};

// F(x) = f(x) - lam'h - (rho/2)||h||^2 - (1/2rho)(||max(0,mu-rho c)||^2
//        - ||mu||^2)   (constrained.py's penalty, maximization form)
double aug_penalty(AugCtx* c, const double* x, int32_t n) {
  double p = 0.0;
  if (c->m_eq) {
    c->eq(c->hbuf, x, n, c->user);
    for (int32_t j = 0; j < c->m_eq; ++j) {
      p += c->lam[j] * c->hbuf[j] + 0.5 * c->rho * c->hbuf[j] * c->hbuf[j];
    }
  }
  if (c->m_in) {
    c->ineq(c->cbuf, x, n, c->user);
    for (int32_t j = 0; j < c->m_in; ++j) {
      const double t = std::max(0.0, c->mu[j] - c->rho * c->cbuf[j]);
      p += (0.5 / c->rho) * (t * t - c->mu[j] * c->mu[j]);
    }
  }
  return p;
}

double aug_value(const double* x, int32_t n, void* vctx) {
  AugCtx* c = static_cast<AugCtx*>(vctx);
  return c->f(x, n, c->user) - aug_penalty(c, x, n);
}

// grad F = grad f - Jh'(lam + rho h) + Jc' max(0, mu - rho c)
double aug_value_grad(double* g, const double* x, int32_t n, void* vctx) {
  AugCtx* c = static_cast<AugCtx*>(vctx);
  double fv = c->fg(g, x, n, c->user);
  double p = 0.0;
  if (c->m_eq) {
    c->eq(c->hbuf, x, n, c->user);
    for (int32_t j = 0; j < c->m_eq; ++j) {
      p += c->lam[j] * c->hbuf[j] + 0.5 * c->rho * c->hbuf[j] * c->hbuf[j];
      c->wbuf[j] = -(c->lam[j] + c->rho * c->hbuf[j]);
    }
    c->eq_vjp(g, x, c->wbuf, n, c->user);
  }
  if (c->m_in) {
    c->ineq(c->cbuf, x, n, c->user);
    for (int32_t j = 0; j < c->m_in; ++j) {
      const double t = std::max(0.0, c->mu[j] - c->rho * c->cbuf[j]);
      p += (0.5 / c->rho) * (t * t - c->mu[j] * c->mu[j]);
      c->wbuf[j] = t;
    }
    c->in_vjp(g, x, c->wbuf, n, c->user);
  }
  return fv - p;
}

}  // namespace

// Constrained solve. Engines: 0 = BFGS (backtracking), 1 = L-BFGS,
// 2 = nonlinear CG with the Hager-Zhang approximate Wolfe (the JAX
// auglag's default rationale: an active constraint makes |F*| > 0 and
// growing rho ill-conditions F — the regime where the Armijo VALUE test
// dies at the fp floor). Returns f(x) on the KKT certificate (inner
// CONVERGED and violation <= ctol), NaN in-band otherwise; out_status
// mirrors constrained.py (hard = non-finite only; soft inner outcomes
// continue the outer loop).
double qnm_auglag_optimize(
    value_grad_fn fg, value_fn f, void* user, int32_t n,
    constraint_fn eq, constraint_vjp_fn eq_vjp, int32_t m_eq,
    constraint_fn ineq, constraint_vjp_fn in_vjp, int32_t m_in,
    const double* x0, const double* lam0, const double* mu0, double rho0,
    double rho_growth, double rho_max, double viol_decrease, double tol,
    double ctol, int32_t max_outer, int32_t engine, int32_t history,
    int32_t order, double ls_c1, double rho_hi, double rho_lo,
    int32_t ls_iterations, int32_t max_iterations, double* out_x,
    double* out_grad, double* out_lam, double* out_mu, double* out_viol,
    double* out_rho, int32_t* out_status, int32_t* out_nouter,
    int32_t* out_iterations, int64_t* out_nfev, int64_t* out_ngev) {
  const double NaN = std::numeric_limits<double>::quiet_NaN();
  *out_status = kMaxIterations;
  *out_nouter = 0;
  *out_iterations = 0;
  *out_nfev = 0;
  *out_ngev = 0;
  *out_viol = NaN;
  *out_rho = rho0;
  if ((m_eq <= 0 && m_in <= 0) || m_eq < 0 || m_in < 0 || max_outer < 1 ||
      !(rho0 > 0.0) || rho_growth < 1.0 || rho_max < rho0 || engine < 0 ||
      engine > 2) {
    *out_status = kNonfiniteValue;
    return NaN;
  }

  std::vector<double> x(x0, x0 + n);
  std::vector<double> lam(m_eq, 0.0), mu(m_in, 0.0);
  if (lam0) std::copy(lam0, lam0 + m_eq, lam.begin());
  if (mu0) std::copy(mu0, mu0 + m_in, mu.begin());
  std::vector<double> hbuf(std::max<int32_t>(m_eq, 1)),
      cbuf(std::max<int32_t>(m_in, 1)),
      wbuf(std::max<int32_t>(std::max(m_eq, m_in), 1));

  double rho = rho0, vprev = std::numeric_limits<double>::infinity();
  bool success = false, hard = false;
  int32_t inner_st = kRunning;

  for (int32_t k = 0; k < max_outer; ++k) {
    AugCtx ctx{fg,   f,     user, eq,          eq_vjp, m_eq,
               ineq, in_vjp, m_in, lam.data(), mu.data(), rho,
               hbuf.data(), cbuf.data(), wbuf.data()};
    int32_t st = kRunning, it = 0;
    int64_t nf = 0, ng = 0;
    if (engine == 2) {
      qnm_cg_optimize(&aug_value_grad, &ctx, n, x.data(), /*hz*/ 0, ls_c1,
                      /*c2*/ 0.9, ls_iterations, /*approx*/ 1,
                      /*approx_eps*/ 1e-6, /*restart_nu*/ 0.2, tol,
                      max_iterations, out_x, out_grad, &st, &it, &nf, &ng);
    } else if (engine == 1) {
      qnm_lbfgs_optimize(&aug_value_grad, &aug_value, &ctx, n, x.data(),
                         history, order, ls_c1, rho_hi, rho_lo,
                         ls_iterations, tol, max_iterations, out_x,
                         out_grad, &st, &it, &nf, &ng);
    } else {
      qnm_bfgs_optimize(&aug_value_grad, &aug_value, &ctx, n, x.data(),
                        order, ls_c1, rho_hi, rho_lo, ls_iterations, tol,
                        max_iterations, /*h0_scale*/ 1, out_x, out_grad,
                        &st, &it, &nf, &ng);
    }
    std::copy(out_x, out_x + n, x.begin());
    *out_iterations += it;
    *out_nfev += nf;
    *out_ngev += ng;
    *out_nouter = k + 1;
    inner_st = st;

    double v = 0.0;
    if (m_eq) {
      eq(hbuf.data(), x.data(), n, user);
      for (int32_t j = 0; j < m_eq; ++j)
        v = std::max(v, std::abs(hbuf[j]));
    }
    if (m_in) {
      ineq(cbuf.data(), x.data(), n, user);
      for (int32_t j = 0; j < m_in; ++j)
        v = std::max(v, std::abs(std::min(cbuf[j], mu[j] / rho)));
    }
    for (int32_t j = 0; j < m_eq; ++j) lam[j] += rho * hbuf[j];
    for (int32_t j = 0; j < m_in; ++j)
      mu[j] = std::max(0.0, mu[j] - rho * cbuf[j]);
    *out_viol = v;
    success = (st == kConverged) && (v <= ctol);
    hard = (st == kNonfiniteValue);
    if (v > viol_decrease * vprev) rho = std::min(rho * rho_growth, rho_max);
    vprev = v;
    if (success || hard) break;
  }

  std::copy(lam.begin(), lam.end(), out_lam);
  std::copy(mu.begin(), mu.end(), out_mu);
  *out_rho = rho;
  const double fv = fg(out_grad, x.data(), n, user);  // true f and grad f
  std::copy(x.begin(), x.end(), out_x);
  *out_status = success ? kConverged : (hard ? inner_st : kMaxIterations);
  return success ? fv : NaN;
}

// Benchmark convenience: the threaded fleet on the built-in Rosenbrock —
// the host-side counterpart of the accelerator fleet benchmark (no Python in the
// hot path, so the pool actually scales).
int32_t qnm_bfgs_optimize_rosenbrock_batch(
    int32_t n, int32_t batch, const double* x0s, int32_t order, double tol,
    int32_t max_iterations, int32_t h0_scale, int32_t n_threads,
    double* out_f, double* out_x, double* out_grad, int32_t* out_status,
    int32_t* out_iterations, int64_t* out_nfev, int64_t* out_ngev) {
  return qnm_bfgs_optimize_batch(
      &qnm_rosenbrock_value_grad, &qnm_rosenbrock_value, nullptr, n, batch,
      x0s, order, 1e-4, 0.5, 0.1, 1000, tol, max_iterations, h0_scale,
      n_threads, out_f, out_x, out_grad, out_status, out_iterations,
      out_nfev, out_ngev);
}

}  // extern "C"
