// Exact 1-D k-means via dynamic programming (this framework's
// equivalent of the reference's flash1dkmeans exact scalar clustering,
// lib/quantizer/vq_quant.py:12-33).
//
// Optimal 1-D k-means clusters are contiguous in sorted order, so
//   D[c][i] = min_{j<=i} D[c-1][j-1] + ssq(j, i)
// with ssq from prefix sums (O(1) per evaluation).  The inner min is
// computed with the divide-and-conquer monotone-argmin optimization
// (the split point is monotone in i), giving O(k n log n) total.
//
// Input x must be SORTED ascending.  Weighted variant supports binned
// data (counts per distinct value).

#include <cstdint>
#include <vector>
#include <algorithm>
#include <cmath>

namespace {

struct Pref {
  std::vector<double> w, wx, wxx;  // prefix sums of weight, w*x, w*x^2
  // ssq of [i, j] (inclusive, 0-based)
  inline double cost(int64_t i, int64_t j) const {
    double W = w[j + 1] - w[i];
    if (W <= 0.0) return 0.0;
    double S = wx[j + 1] - wx[i];
    double Q = wxx[j + 1] - wxx[i];
    return Q - S * S / W;
  }
  inline double mean(int64_t i, int64_t j) const {
    double W = w[j + 1] - w[i];
    return W > 0.0 ? (wx[j + 1] - wx[i]) / W : 0.0;
  }
};

// Fill row D[i] = min over split j in [lo_j, hi_j] of prev[j-1]+cost(j,i)
// for i in [lo, hi], exploiting argmin monotonicity.
void dnc_row(const Pref& P, const std::vector<double>& prev,
             std::vector<double>& cur, std::vector<int64_t>& arg,
             int64_t lo, int64_t hi, int64_t jlo, int64_t jhi) {
  if (lo > hi) return;
  int64_t mid = (lo + hi) / 2;
  double best = 1e300;
  int64_t bestj = jlo;
  int64_t jmax = std::min(mid, jhi);
  for (int64_t j = jlo; j <= jmax; ++j) {
    double v = (j > 0 ? prev[j - 1] : (j == 0 ? 0.0 : 1e300))
               + P.cost(j, mid);
    if (v < best) { best = v; bestj = j; }
  }
  cur[mid] = best;
  arg[mid] = bestj;
  dnc_row(P, prev, cur, arg, lo, mid - 1, jlo, bestj);
  dnc_row(P, prev, cur, arg, mid + 1, hi, bestj, jhi);
}

}  // namespace

extern "C" {

// x: sorted ascending (n); w: weights (n) or nullptr for unweighted;
// centroids_out: (k).  Returns the optimal within-cluster ssq.
double qpt_kmeans1d(const double* x, const double* w, int64_t n, int k,
                    double* centroids_out) {
  if (n <= 0 || k <= 0) return 0.0;
  Pref P;
  P.w.resize(n + 1, 0.0);
  P.wx.resize(n + 1, 0.0);
  P.wxx.resize(n + 1, 0.0);
  for (int64_t i = 0; i < n; ++i) {
    double wi = w ? w[i] : 1.0;
    P.w[i + 1] = P.w[i] + wi;
    P.wx[i + 1] = P.wx[i] + wi * x[i];
    P.wxx[i + 1] = P.wxx[i] + wi * x[i] * x[i];
  }
  if (k >= n) {  // every point its own centroid (pad by repetition)
    for (int c = 0; c < k; ++c)
      centroids_out[c] = x[std::min<int64_t>(c, n - 1)];
    return 0.0;
  }
  std::vector<double> prev(n), cur(n);
  std::vector<int64_t> arg(n);
  // back-pointers per cluster row (k x n int64 = fine for n ~ 1e6, k<=256
  // -> 2 GB at k=256, n=1e6... too much; store splits per row compressed
  // as int32)
  std::vector<std::vector<int32_t>> splits(k);
  for (int64_t i = 0; i < n; ++i) prev[i] = P.cost(0, i);
  for (int c = 1; c < k; ++c) {
    dnc_row(P, prev, cur, arg, 0, n - 1, 0, n - 1);
    splits[c].resize(n);
    for (int64_t i = 0; i < n; ++i) splits[c][i] = (int32_t)arg[i];
    std::swap(prev, cur);
  }
  // backtrack cluster boundaries
  int64_t end = n - 1;
  std::vector<int64_t> starts(k);
  for (int c = k - 1; c >= 1; --c) {
    int64_t s = splits[c][end];
    starts[c] = s;
    end = s - 1;
  }
  starts[0] = 0;
  for (int c = 0; c < k; ++c) {
    int64_t s = starts[c];
    int64_t e = (c + 1 < k ? starts[c + 1] - 1 : n - 1);
    centroids_out[c] = P.mean(s, e);
  }
  return prev[n - 1];
}

}  // extern "C"
