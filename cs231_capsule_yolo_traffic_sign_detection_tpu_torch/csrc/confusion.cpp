// Native confusion-sweep kernel for detection metrics.
//
// The detect_AP / mAP metrics sweep a 10x100 (iou_th x conf_th) grid
// over per-image box sets (reference metrics.py:193-339 does this with
// four nested Python loops).  This kernel evaluates the whole sweep
// for one image in tight loops over the precomputed IoU matrix; the
// Python layer accumulates across images.  Semantics match
// metrics/detection.py::confusion_sweep exactly (strict conf > th;
// a gt counts as hit if ANY included pred overlaps above iou_th; a
// pred counts as hit if it overlaps ANY included gt).
//
// The PyTorch port's copy of the JAX package's native/confusion.cpp,
// built with g++ at first use by metrics/_native.py into build/native/
// as a plain shared library, bound via ctypes (no pybind11).

#include <cstdint>
#include <cstddef>
using std::size_t;
#include <vector>

extern "C" {

// Pairwise IoU of corner boxes; iou[g * n_pr + p].
// Matches the scalar reference (metrics.py:99-133): exactly 0 when the
// boxes do not properly overlap.
void pairwise_iou(const double* gt_xy, int64_t n_gt,
                  const double* pr_xy, int64_t n_pr,
                  double* iou) {
  for (int64_t g = 0; g < n_gt; ++g) {
    const double gx1 = gt_xy[g * 4 + 0], gy1 = gt_xy[g * 4 + 1];
    const double gx2 = gt_xy[g * 4 + 2], gy2 = gt_xy[g * 4 + 3];
    const double ga = (gx2 - gx1) * (gy2 - gy1);
    for (int64_t p = 0; p < n_pr; ++p) {
      const double px1 = pr_xy[p * 4 + 0], py1 = pr_xy[p * 4 + 1];
      const double px2 = pr_xy[p * 4 + 2], py2 = pr_xy[p * 4 + 3];
      const double ix1 = gx1 > px1 ? gx1 : px1;
      const double iy1 = gy1 > py1 ? gy1 : py1;
      const double ix2 = gx2 < px2 ? gx2 : px2;
      const double iy2 = gy2 < py2 ? gy2 : py2;
      const double iw = ix2 - ix1, ih = iy2 - iy1;
      double v = 0.0;
      if (iw > 0.0 && ih > 0.0) {
        const double inter = iw * ih;
        const double pa = (px2 - px1) * (py2 - py1);
        v = inter / (ga + pa - inter);
      }
      iou[g * n_pr + p] = v;
    }
  }
}

// Accumulate TP/FP/FN over the (n_iou x n_conf) sweep for ONE image.
// tp/fp/fn are int64 arrays of length n_iou*n_conf, accumulated +=.
void confusion_sweep_image(const double* gt_xy, const double* gt_conf,
                           int64_t n_gt,
                           const double* pr_xy, const double* pr_conf,
                           int64_t n_pr,
                           const double* iou_ths, int64_t n_iou,
                           const double* conf_ths, int64_t n_conf,
                           int64_t* tp, int64_t* fp, int64_t* fn) {
  std::vector<double> iou((size_t)(n_gt * n_pr));
  pairwise_iou(gt_xy, n_gt, pr_xy, n_pr, iou.data());

  for (int64_t c = 0; c < n_conf; ++c) {
    const double cth = conf_ths[c];
    // included sets at this confidence threshold (strict >)
    std::vector<char> g_in((size_t)n_gt), p_in((size_t)n_pr);
    int64_t n_g_in = 0, n_p_in = 0;
    for (int64_t g = 0; g < n_gt; ++g) {
      g_in[(size_t)g] = gt_conf[g] > cth;
      n_g_in += g_in[(size_t)g];
    }
    for (int64_t p = 0; p < n_pr; ++p) {
      p_in[(size_t)p] = pr_conf[p] > cth;
      n_p_in += p_in[(size_t)p];
    }

    for (int64_t i = 0; i < n_iou; ++i) {
      const double ith = iou_ths[i];
      int64_t gt_hit = 0, pred_hit = 0;
      for (int64_t g = 0; g < n_gt; ++g) {
        if (!g_in[(size_t)g]) continue;
        for (int64_t p = 0; p < n_pr; ++p) {
          if (p_in[(size_t)p] && iou[(size_t)(g * n_pr + p)] > ith) {
            ++gt_hit;
            break;
          }
        }
      }
      for (int64_t p = 0; p < n_pr; ++p) {
        if (!p_in[(size_t)p]) continue;
        for (int64_t g = 0; g < n_gt; ++g) {
          if (g_in[(size_t)g] && iou[(size_t)(g * n_pr + p)] > ith) {
            ++pred_hit;
            break;
          }
        }
      }
      const int64_t idx = i * n_conf + c;
      tp[idx] += gt_hit;
      fp[idx] += n_p_in - pred_hit;
      fn[idx] += n_g_in - gt_hit;
    }
  }
}

}  // extern "C"
