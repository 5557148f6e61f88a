// fire_native: host-side native code of the PyTorch port (the port's own
// copy of the JAX package's native/src/fire_native.cc, same algorithms).
//
// Exposed over a plain C ABI, built at first use with the host C++
// compiler and bound with ctypes (fire_tpu_torch/runtime/native.py).
//
// Contents:
//   fire_lap_solve — rectangular linear assignment (shortest augmenting
//                    path / Jonker-Volgenant-style, O(n^2 m)), matching
//                    scipy.optimize.linear_sum_assignment semantics.
//   fire_nms       — greedy IoU NMS with the legacy +1 / >= variants
//                    used by the reference decode paths.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <numeric>
#include <vector>

extern "C" {

// Solve min-cost assignment over an n x m cost matrix (row-major).
// Writes min(n, m) (row, col) pairs; returns 0 on success.
int fire_lap_solve(int n, int m, const double* cost, int* out_rows,
                   int* out_cols) {
  if (n <= 0 || m <= 0) return 0;
  const bool transposed = n > m;
  const int R = transposed ? m : n;  // rows <= cols
  const int C = transposed ? n : m;
  auto at = [&](int r, int c) -> double {
    return transposed ? cost[c * m + r] : cost[r * m + c];
  };

  const double INF = std::numeric_limits<double>::infinity();
  // potentials and column->row assignment, 1-indexed internally
  std::vector<double> u(R + 1, 0.0), v(C + 1, 0.0);
  std::vector<int> p(C + 1, 0), way(C + 1, 0);

  for (int i = 1; i <= R; ++i) {
    p[0] = i;
    int j0 = 0;
    std::vector<double> minv(C + 1, INF);
    std::vector<char> used(C + 1, 0);
    do {
      used[j0] = 1;
      int i0 = p[j0], j1 = -1;
      double delta = INF;
      for (int j = 1; j <= C; ++j) {
        if (used[j]) continue;
        double cur = at(i0 - 1, j - 1) - u[i0] - v[j];
        if (cur < minv[j]) {
          minv[j] = cur;
          way[j] = j0;
        }
        if (minv[j] < delta) {
          delta = minv[j];
          j1 = j;
        }
      }
      if (j1 < 0) return 1;  // infeasible (shouldn't happen: finite costs)
      for (int j = 0; j <= C; ++j) {
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

  int k = 0;
  for (int j = 1; j <= C; ++j) {
    if (p[j] == 0) continue;
    int r = p[j] - 1, c = j - 1;
    if (transposed) std::swap(r, c);
    out_rows[k] = r;
    out_cols[k] = c;
    ++k;
  }
  return 0;
}

// Greedy NMS over n xyxy boxes; returns number of kept indices written
// to out_keep (in descending-score order).
int fire_nms(int n, const float* boxes, const float* scores,
             float iou_threshold, int plus_one, int suppress_equal,
             int* out_keep) {
  if (n <= 0) return 0;
  const float off = plus_one ? 1.0f : 0.0f;
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int a, int b) { return scores[a] > scores[b]; });
  std::vector<float> area(n);
  for (int i = 0; i < n; ++i) {
    const float* b = boxes + 4 * i;
    area[i] = (b[2] - b[0] + off) * (b[3] - b[1] + off);
  }
  std::vector<char> suppressed(n, 0);
  int k = 0;
  for (int oi = 0; oi < n; ++oi) {
    int i = order[oi];
    if (suppressed[i]) continue;
    out_keep[k++] = i;
    const float* bi = boxes + 4 * i;
    for (int oj = oi + 1; oj < n; ++oj) {
      int j = order[oj];
      if (suppressed[j]) continue;
      const float* bj = boxes + 4 * j;
      float xx1 = std::max(bi[0], bj[0]);
      float yy1 = std::max(bi[1], bj[1]);
      float xx2 = std::min(bi[2], bj[2]);
      float yy2 = std::min(bi[3], bj[3]);
      float w = std::max(0.0f, xx2 - xx1 + off);
      float h = std::max(0.0f, yy2 - yy1 + off);
      float inter = w * h;
      float ovr = inter / (area[i] + area[j] - inter);
      bool sup = suppress_equal ? (ovr >= iou_threshold) : (ovr > iou_threshold);
      if (sup) suppressed[j] = 1;
    }
  }
  return k;
}

}  // extern "C"
