// Autotuner: Gaussian-process Bayesian optimization with expected
// improvement, over the fusion threshold.
//
// Re-design of the reference ParameterManager + optim/ (reference
// parameter_manager.{h,cc}, optim/bayesian_optimization.cc,
// optim/gaussian_process.cc — which use Eigen + LBFGS).  The tunable
// space here is 1-D (log2 fusion-threshold bytes) so the GP posterior
// and EI maximization run on a dense grid with a hand-rolled Cholesky —
// no Eigen needed.  Score = observed bytes/sec, like the reference.
#include "hvd_core.h"

#include <cmath>
#include <mutex>
#include <vector>

namespace {

struct Autotune {
  double lo, hi;
  std::mutex mu;
  std::vector<double> xs, ys;

  // RBF kernel with unit variance; length scale = 10% of range.
  double kern(double a, double b) const {
    double ls = 0.1 * (hi - lo);
    double d = (a - b) / ls;
    return std::exp(-0.5 * d * d);
  }

  // Cholesky solve of (K + sI) alpha = y; returns false if not SPD.
  static bool chol_solve(std::vector<double>& K, int n,
                         const std::vector<double>& y,
                         std::vector<double>& alpha,
                         std::vector<double>& L) {
    L = K;
    for (int i = 0; i < n; ++i) {
      for (int j = 0; j <= i; ++j) {
        double s = L[i * n + j];
        for (int k = 0; k < j; ++k) s -= L[i * n + k] * L[j * n + k];
        if (i == j) {
          if (s <= 0) return false;
          L[i * n + i] = std::sqrt(s);
        } else {
          L[i * n + j] = s / L[j * n + j];
        }
      }
      for (int j = i + 1; j < n; ++j) L[i * n + j] = 0;
    }
    // forward/back substitution
    std::vector<double> z(n);
    for (int i = 0; i < n; ++i) {
      double s = y[i];
      for (int k = 0; k < i; ++k) s -= L[i * n + k] * z[k];
      z[i] = s / L[i * n + i];
    }
    alpha.assign(n, 0.0);
    for (int i = n - 1; i >= 0; --i) {
      double s = z[i];
      for (int k = i + 1; k < n; ++k) s -= L[k * n + i] * alpha[k];
      alpha[i] = s / L[i * n + i];
    }
    return true;
  }

  // GP posterior at x; mean/var via Cholesky of K + noise.
  void posterior(double x, double* mean, double* var,
                 const std::vector<double>& alpha,
                 const std::vector<double>& L, double ymean) const {
    int n = (int)xs.size();
    std::vector<double> k(n);
    for (int i = 0; i < n; ++i) k[i] = kern(x, xs[i]);
    double m = 0;
    for (int i = 0; i < n; ++i) m += k[i] * alpha[i];
    // v = L^-1 k
    std::vector<double> v(n);
    for (int i = 0; i < n; ++i) {
      double s = k[i];
      for (int j = 0; j < i; ++j) s -= L[i * n + j] * v[j];
      v[i] = s / L[i * n + i];
    }
    double vv = 0;
    for (int i = 0; i < n; ++i) vv += v[i] * v[i];
    *mean = m + ymean;
    *var = std::max(1e-12, 1.0 - vv);
  }
};

double norm_pdf(double z) {
  return std::exp(-0.5 * z * z) / std::sqrt(2 * M_PI);
}
double norm_cdf(double z) { return 0.5 * std::erfc(-z / std::sqrt(2.0)); }

}  // namespace

extern "C" {

void* hvd_autotune_new(double lo, double hi) {
  auto* a = new Autotune();
  a->lo = lo;
  a->hi = hi;
  return a;
}
void hvd_autotune_free(void* p) { delete static_cast<Autotune*>(p); }

void hvd_autotune_observe(void* p, double x, double score) {
  auto* a = static_cast<Autotune*>(p);
  if (!a) return;
  std::lock_guard<std::mutex> lock(a->mu);
  a->xs.push_back(x);
  a->ys.push_back(score);
}

double hvd_autotune_suggest(void* p) {
  auto* a = static_cast<Autotune*>(p);
  if (!a) return 0;
  std::lock_guard<std::mutex> lock(a->mu);
  int n = (int)a->xs.size();
  // Bootstrap: probe endpoints and midpoint before modeling.
  if (n == 0) return a->lo;
  if (n == 1) return a->hi;
  if (n == 2) return 0.5 * (a->lo + a->hi);

  // Normalize y to zero mean, unit-ish scale for the GP.
  double ymean = 0, ymax = -1e300;
  for (double y : a->ys) ymean += y;
  ymean /= n;
  double yscale = 0;
  for (double y : a->ys) yscale = std::max(yscale, std::fabs(y - ymean));
  if (yscale <= 0) yscale = 1;
  std::vector<double> yn(n);
  for (int i = 0; i < n; ++i) {
    yn[i] = (a->ys[i] - ymean) / yscale;
    ymax = std::max(ymax, yn[i]);
  }
  std::vector<double> K(n * n);
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j)
      K[i * n + j] = a->kern(a->xs[i], a->xs[j]) + (i == j ? 1e-4 : 0.0);
  std::vector<double> alpha, L;
  if (!Autotune::chol_solve(K, n, yn, alpha, L)) return 0.5 * (a->lo + a->hi);

  // EI maximization on a grid.
  double best_x = a->lo, best_ei = -1;
  const int kGrid = 128;
  for (int g = 0; g <= kGrid; ++g) {
    double x = a->lo + (a->hi - a->lo) * g / kGrid;
    double mean, var;
    a->posterior(x, &mean, &var, alpha, L, 0.0);
    double sd = std::sqrt(var);
    double xi = 0.01;  // exploration margin (reference uses EI too)
    double z = (mean - ymax - xi) / sd;
    double ei = (mean - ymax - xi) * norm_cdf(z) + sd * norm_pdf(z);
    if (ei > best_ei) { best_ei = ei; best_x = x; }
  }
  return best_x;
}

double hvd_autotune_best(void* p, double* out_score) {
  auto* a = static_cast<Autotune*>(p);
  if (!a) return 0;
  std::lock_guard<std::mutex> lock(a->mu);
  double bx = 0, by = -1e300;
  for (size_t i = 0; i < a->xs.size(); ++i)
    if (a->ys[i] > by) { by = a->ys[i]; bx = a->xs[i]; }
  if (out_score) *out_score = by;
  return bx;
}

}  // extern "C"
