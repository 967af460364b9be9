// Native edge-proposal kernels for the factor graph.
//
// The reference runs these greedy distance-sorted NMS loops in Python on
// the GPU process (src/factor_graph.py:323-462); at backend scale the
// O(t^2) candidate sweep with nested suppression windows is a host hotspot.
// Here they are C++ (built once into libproximity.so, loaded via ctypes;
// this is the torch port's own copy, built by glorie_slam_tpu_torch/build.py).
//
// Semantics mirror the reference exactly:
//   * proximity_edges  — factor_graph.py:323-383 (frontend proposal)
//   * backend_proximity_edges — factor_graph.py:386-462 (global/loop
//     proposal incl. "si - sj > 20" loop-edge rule)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

namespace {
constexpr float INF = std::numeric_limits<float>::infinity();
}

extern "C" {

// Frontend proximity proposal. d is the (ilen x jlen) bidirectional
// distance matrix for ii in [t0, t), jj in [t1, t). Existing edges
// (n_exist) seed the NMS suppression. Returns the number of edges written
// to out_ii/out_jj (capacity max_out).
int64_t proximity_edges(
    float* d, int64_t t0, int64_t t1, int64_t t,
    int64_t rad, int64_t nms, float thresh, int64_t max_factors,
    const int64_t* exist_ii, const int64_t* exist_jj, int64_t n_exist,
    int64_t* out_ii, int64_t* out_jj, int64_t max_out) {
  const int64_t ilen = t - t0;
  const int64_t jlen = t - t1;
  if (ilen <= 0 || jlen <= 0) return 0;

  auto D = [&](int64_t i, int64_t j) -> float& { return d[i * jlen + j]; };

  // mask: ii - rad < jj or d > 100 (factor_graph.py:335-336)
  for (int64_t i = 0; i < ilen; i++) {
    for (int64_t j = 0; j < jlen; j++) {
      const int64_t gi = i + t0, gj = j + t1;
      if (gi - rad < gj || D(i, j) > 100.0f) D(i, j) = INF;
    }
  }

  auto suppress = [&](int64_t gi, int64_t gj) {
    const int64_t di_max =
        std::max<int64_t>(std::min<int64_t>(std::llabs(gi - gj) - 2, nms), 0);
    for (int64_t di = -nms; di <= nms; di++) {
      for (int64_t dj = -nms; dj <= nms; dj++) {
        if (std::llabs(di) + std::llabs(dj) <= di_max) {
          const int64_t i1 = gi + di, j1 = gj + dj;
          if (t0 <= i1 && i1 < t && t1 <= j1 && j1 < t)
            D(i1 - t0, j1 - t1) = INF;
        }
      }
    }
  };

  for (int64_t n = 0; n < n_exist; n++) suppress(exist_ii[n], exist_jj[n]);

  int64_t n_out = 0;
  auto push = [&](int64_t a, int64_t b) {
    if (n_out < max_out) {
      out_ii[n_out] = a;
      out_jj[n_out] = b;
      n_out++;
    }
  };

  // local edges within [i-rad-1, i) (factor_graph.py:352-356)
  for (int64_t gi = t0; gi < t; gi++) {
    for (int64_t gj = std::max<int64_t>(gi - rad - 1, 0); gj < gi; gj++) {
      push(gi, gj);
      push(gj, gi);
      if (t1 <= gj && gj < t) D(gi - t0, gj - t1) = INF;
    }
  }

  // distance-sorted greedy selection (factor_graph.py:358-380)
  std::vector<int64_t> order(ilen * jlen);
  for (int64_t k = 0; k < (int64_t)order.size(); k++) order[k] = k;
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t a, int64_t b) { return d[a] < d[b]; });

  for (int64_t k : order) {
    if (d[k] > thresh || std::isinf(d[k])) continue;
    if (max_factors > 0 && n_out > max_factors) break;
    const int64_t gi = k / jlen + t0;
    const int64_t gj = k % jlen + t1;
    push(gi, gj);
    push(gj, gi);
    suppress(gi, gj);
  }
  return n_out;
}

// Backend/global proposal with optional loop edges
// (factor_graph.py:386-462). rawd is an unmasked copy of d.
int64_t backend_proximity_edges(
    float* d, const float* rawd,
    int64_t t_start, int64_t t_end, int64_t t_start_loop,
    int64_t nms, int64_t radius, float thresh, int64_t max_factors,
    int64_t loop, int64_t* out_ii, int64_t* out_jj, int64_t max_out) {
  const int64_t ilen = t_end - t_start_loop;
  const int64_t jlen = t_end - t_start;
  if (ilen <= 0 || jlen <= 0) return 0;
  auto D = [&](int64_t i, int64_t j) -> float& { return d[i * jlen + j]; };
  auto RD = [&](int64_t i, int64_t j) -> float {
    return rawd[i * jlen + j];
  };

  for (int64_t i = 0; i < ilen; i++) {
    for (int64_t j = 0; j < jlen; j++) {
      const int64_t gi = i + t_start_loop, gj = j + t_start;
      if (gi - radius < gj || D(i, j) > thresh) D(i, j) = INF;
    }
  }

  int64_t n_out = 0;
  auto push = [&](int64_t a, int64_t b) {
    if (n_out < max_out) {
      out_ii[n_out] = a;
      out_jj[n_out] = b;
      n_out++;
    }
  };

  // local window edges (factor_graph.py:408-414)
  for (int64_t gi = t_start_loop; gi < t_end; gi++) {
    for (int64_t gj = std::max<int64_t>(gi - radius - 1, 0); gj < gi; gj++) {
      push(gi, gj);
      push(gj, gi);
      D(gi - t_start_loop, gj - t_start) = INF;
    }
  }

  std::vector<int64_t> order(ilen * jlen);
  for (int64_t k = 0; k < (int64_t)order.size(); k++) order[k] = k;
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t a, int64_t b) { return d[a] < d[b]; });

  int64_t loop_edges = 0;
  const int64_t n_neighboring = 1;
  for (int64_t k : order) {
    const int64_t di = k / jlen, dj = k % jlen;
    if (d[k] > thresh || std::isinf(d[k])) continue;
    if (n_out > max_factors) break;
    const int64_t gi = di + t_start_loop;
    const int64_t gj = dj + t_start;
    if (loop) {
      // neighborhood loop edges where si - sj > 20 (factor_graph.py:437-447)
      for (int64_t si = std::max(gi - n_neighboring, t_start_loop);
           si < std::min(gi + n_neighboring + 1, t_end); si++) {
        for (int64_t sj = std::max(gj - n_neighboring, t_start);
             sj < std::min(gj + n_neighboring + 1, t_end); sj++) {
          if (RD(si - t_start_loop, sj - t_start) <= thresh && si != sj &&
              si - sj > 20) {
            push(si, sj);
            loop_edges++;
          }
        }
      }
    } else {
      push(gi, gj);
      push(gj, gi);
    }
    // rectangular NMS (factor_graph.py:452)
    for (int64_t i1 = std::max<int64_t>(0, di - nms);
         i1 < std::min(ilen, di + nms + 1); i1++) {
      for (int64_t j1 = std::max<int64_t>(0, dj - nms);
           j1 < std::min(jlen, dj + nms + 1); j1++) {
        D(i1, j1) = INF;
      }
    }
  }
  // loop runs with zero loop edges are rejected by the caller
  if (loop && loop_edges == 0) return -1;
  return n_out;
}

}  // extern "C"
