// Fused KITTI-eval statistics loops (C++ fast path).
//
// Mirrors the matching semantics of datasets/kitti/kitti_object_eval/eval.py
// compute_statistics (itself a statement-for-statement port of the official
// protocol, reference kitti_object_eval_python/eval.py:157-287). The
// reference runs these loops under @numba.jit and fuses the per-threshold
// sweep (fused_compute_statistics, eval.py:291); plain Python is ~20x too
// slow at the 3,769-frame val-split scale, so the same fusion lives here.
//
// Exported via ctypes from native/__init__.py; eval.py falls back to the
// Python loops when the library is unavailable, keeping results identical.

#include <cstdint>
#include <cmath>
#include <vector>

namespace {
constexpr double kNoDetection = -10000000.0;
}

extern "C" {

// First pass (compute_fp=false, thresh=0): collect the scores of matched
// detections. Returns the number of scores written to out_scores (caller
// allocates gt_size doubles).
int32_t kitti_tp_scores(const double* overlaps,  // (det_size, gt_size) row-major
                        int32_t det_size, int32_t gt_size,
                        const double* dt_scores,
                        const int32_t* ignored_gt,
                        const int32_t* ignored_det,
                        double min_overlap,
                        double* out_scores) {
  std::vector<char> assigned(det_size, 0);
  int32_t n_out = 0;
  for (int32_t i = 0; i < gt_size; ++i) {
    if (ignored_gt[i] == -1) continue;
    int32_t det_idx = -1;
    double valid_detection = kNoDetection;
    for (int32_t j = 0; j < det_size; ++j) {
      if (ignored_det[j] == -1 || assigned[j]) continue;
      const double overlap = overlaps[(int64_t)j * gt_size + i];
      if (overlap > min_overlap && dt_scores[j] > valid_detection) {
        det_idx = j;
        valid_detection = dt_scores[j];
      }
    }
    if (valid_detection == kNoDetection) continue;
    if (ignored_gt[i] == 1 || ignored_det[det_idx] == 1) {
      assigned[det_idx] = 1;
    } else {
      out_scores[n_out++] = dt_scores[det_idx];
      assigned[det_idx] = 1;
    }
  }
  return n_out;
}

// Second pass fused over thresholds (compute_fp=true): accumulates
// pr[t][0..3] += (tp, fp, fn, similarity) for each of n_thresh thresholds.
// dt_dc_overlap is the (det_size, n_dc) image_box_overlap(dt, dc,
// criterion=0) matrix (only consulted when metric == 0), may be null when
// n_dc == 0. similarity accumulates only when compute_aos != 0.
void kitti_fused_stats(const double* overlaps,  // (det_size, gt_size)
                       int32_t det_size, int32_t gt_size,
                       const double* dt_scores,
                       const double* dt_alphas,
                       const double* gt_alphas,
                       const double* dt_dc_overlap, int32_t n_dc,
                       const int32_t* ignored_gt,
                       const int32_t* ignored_det,
                       int32_t metric, double min_overlap,
                       const double* thresholds, int32_t n_thresh,
                       int32_t compute_aos,
                       double* pr /* (n_thresh, 4) */) {
  std::vector<char> assigned(det_size);
  std::vector<char> ignored_threshold(det_size);
  std::vector<double> delta(gt_size);

  for (int32_t t = 0; t < n_thresh; ++t) {
    const double thresh = thresholds[t];
    std::fill(assigned.begin(), assigned.end(), 0);
    for (int32_t j = 0; j < det_size; ++j)
      ignored_threshold[j] = dt_scores[j] < thresh;

    int64_t tp = 0, fp = 0, fn = 0;
    int32_t n_delta = 0;
    for (int32_t i = 0; i < gt_size; ++i) {
      if (ignored_gt[i] == -1) continue;
      int32_t det_idx = -1;
      double valid_detection = kNoDetection;
      double max_overlap = 0.0;
      bool assigned_ignored_det = false;
      const double* ov_col = overlaps + i;
      for (int32_t j = 0; j < det_size; ++j) {
        if (ignored_det[j] == -1 || assigned[j] || ignored_threshold[j])
          continue;
        const double overlap = ov_col[(int64_t)j * gt_size];
        if (overlap > min_overlap &&
            (overlap > max_overlap || assigned_ignored_det) &&
            ignored_det[j] == 0) {
          max_overlap = overlap;
          det_idx = j;
          valid_detection = 1.0;
          assigned_ignored_det = false;
        } else if (overlap > min_overlap && valid_detection == kNoDetection &&
                   ignored_det[j] == 1) {
          det_idx = j;
          valid_detection = 1.0;
          assigned_ignored_det = true;
        }
      }
      if (valid_detection == kNoDetection && ignored_gt[i] == 0) {
        fn += 1;
      } else if (valid_detection != kNoDetection &&
                 (ignored_gt[i] == 1 || ignored_det[det_idx] == 1)) {
        assigned[det_idx] = 1;
      } else if (valid_detection != kNoDetection) {
        tp += 1;
        if (compute_aos) delta[n_delta++] = gt_alphas[i] - dt_alphas[det_idx];
        assigned[det_idx] = 1;
      }
    }

    for (int32_t j = 0; j < det_size; ++j) {
      if (!(assigned[j] || ignored_det[j] == -1 || ignored_det[j] == 1 ||
            ignored_threshold[j]))
        fp += 1;
    }
    int64_t nstuff = 0;
    if (metric == 0 && n_dc > 0) {
      for (int32_t i = 0; i < n_dc; ++i) {
        for (int32_t j = 0; j < det_size; ++j) {
          if (assigned[j] || ignored_det[j] == -1 || ignored_det[j] == 1 ||
              ignored_threshold[j])
            continue;
          if (dt_dc_overlap[(int64_t)j * n_dc + i] > min_overlap) {
            assigned[j] = 1;
            nstuff += 1;
          }
        }
      }
    }
    fp -= nstuff;

    double similarity = 0.0;
    if (compute_aos) {
      if (tp > 0 || fp > 0) {
        for (int32_t k = 0; k < n_delta; ++k)
          similarity += (1.0 + std::cos(delta[k])) / 2.0;
      } else {
        similarity = -1.0;
      }
    }

    pr[(int64_t)t * 4 + 0] += (double)tp;
    pr[(int64_t)t * 4 + 1] += (double)fp;
    pr[(int64_t)t * 4 + 2] += (double)fn;
    if (compute_aos && similarity != -1.0) pr[(int64_t)t * 4 + 3] += similarity;
  }
}

}  // extern "C"
