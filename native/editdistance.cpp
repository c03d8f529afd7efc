// Native metric cores for whisper_ipa.metrics.
//
// Replaces the reference's third-party C++ editdistance extension
// (reference scripts/evaluate_ipa.py:100) and provides fast DP cores for the
// feature-weighted PFER variants, which dominate evaluation wall-clock at
// scale. Exposed through ctypes (see whisper_ipa/metrics/native.py).
//
// Build: make -C native   (produces libwipa_native.so)

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Plain Levenshtein over integer id sequences.
int64_t wipa_levenshtein(const int64_t* a, int64_t m, const int64_t* b,
                         int64_t n) {
  if (m == 0) return n;
  if (n == 0) return m;
  std::vector<int64_t> prev(n + 1), cur(n + 1);
  for (int64_t j = 0; j <= n; ++j) prev[j] = j;
  for (int64_t i = 1; i <= m; ++i) {
    cur[0] = i;
    const int64_t ai = a[i - 1];
    for (int64_t j = 1; j <= n; ++j) {
      const int64_t sub = prev[j - 1] + (b[j - 1] != ai);
      cur[j] = std::min({prev[j] + 1, cur[j - 1] + 1, sub});
    }
    std::swap(prev, cur);
  }
  return prev[n];
}

// Weighted edit distance: insertion/deletion cost 1, substitution cost from
// sub_cost (row-major m x n). PFER-Hamming DP core.
double wipa_weighted_edit_distance(const double* sub_cost, int64_t m,
                                   int64_t n) {
  std::vector<double> prev(n + 1), cur(n + 1);
  for (int64_t j = 0; j <= n; ++j) prev[j] = static_cast<double>(j);
  for (int64_t i = 1; i <= m; ++i) {
    cur[0] = static_cast<double>(i);
    const double* row = sub_cost + (i - 1) * n;
    for (int64_t j = 1; j <= n; ++j) {
      const double del = prev[j] + 1.0;
      const double ins = cur[j - 1] + 1.0;
      const double sub = prev[j - 1] + row[j - 1];
      cur[j] = std::min({del, ins, sub});
    }
    std::swap(prev, cur);
  }
  return prev[n];
}

// Taguchi LPhD_combined DP core: equal cells inherit the diagonal; unequal
// cells take min(left, up, diag) + penalty, penalty shared by all three ops.
double wipa_cosine_edit_distance(const double* penalty, const uint8_t* equal,
                                 int64_t m, int64_t n) {
  std::vector<double> prev(n + 1), cur(n + 1);
  for (int64_t j = 0; j <= n; ++j) prev[j] = static_cast<double>(j);
  for (int64_t i = 1; i <= m; ++i) {
    cur[0] = static_cast<double>(i);
    const double* prow = penalty + (i - 1) * n;
    const uint8_t* erow = equal + (i - 1) * n;
    for (int64_t j = 1; j <= n; ++j) {
      if (erow[j - 1]) {
        cur[j] = prev[j - 1];
      } else {
        cur[j] =
            std::min({cur[j - 1], prev[j], prev[j - 1]}) + prow[j - 1];
      }
    }
    std::swap(prev, cur);
  }
  return prev[n];
}

}  // extern "C"
