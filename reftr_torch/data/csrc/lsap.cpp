// Linear sum assignment (Jonker-Volgenant shortest augmenting path).
//
// Native replacement for scipy.optimize.linear_sum_assignment as used by the
// reference's HungarianMatcher (models/modeling/matcher.py:14,163 of
// the reference RefTR). Capability parity: the live criterion is matcher-free
// (num_queries_per_phrase == 1), but the --set_cost_* knobs exist.
//
// Solves min-cost assignment for an n x m cost matrix (n <= m) in O(n^2 m).
// C ABI for ctypes.

#include <cfloat>
#include <cstdint>
#include <vector>

extern "C" {

// cost: row-major [n, m], n <= m. Writes row_to_col[n] (the assigned column
// per row). Returns 0 on success, -1 on bad input.
int lsap_solve(const double* cost, int n, int m, int32_t* row_to_col) {
  if (n <= 0 || m <= 0 || n > m) return -1;
  // Jonker-Volgenant with dual variables u (rows), v (cols).
  std::vector<double> u(n + 1, 0.0), v(m + 1, 0.0);
  std::vector<int> p(m + 1, 0);    // p[j]: row matched to col j (1-based)
  std::vector<int> way(m + 1, 0);
  for (int i = 1; i <= n; ++i) {
    p[0] = i;
    int j0 = 0;
    std::vector<double> minv(m + 1, DBL_MAX);
    std::vector<char> used(m + 1, 0);
    do {
      used[j0] = 1;
      int i0 = p[j0], j1 = -1;
      double delta = DBL_MAX;
      for (int j = 1; j <= m; ++j) {
        if (used[j]) continue;
        double cur = cost[(i0 - 1) * m + (j - 1)] - u[i0] - v[j];
        if (cur < minv[j]) {
          minv[j] = cur;
          way[j] = j0;
        }
        if (minv[j] < delta) {
          delta = minv[j];
          j1 = j;
        }
      }
      for (int j = 0; j <= m; ++j) {
        if (used[j]) {
          u[p[j]] += delta;
          v[j] -= delta;
        } else {
          minv[j] -= delta;
        }
      }
      j0 = j1;
    } while (p[j0] != 0);
    do {
      int j1 = way[j0];
      p[j0] = p[j1];
      j0 = j1;
    } while (j0);
  }
  for (int j = 1; j <= m; ++j)
    if (p[j] > 0) row_to_col[p[j] - 1] = j - 1;
  return 0;
}

}  // extern "C"
