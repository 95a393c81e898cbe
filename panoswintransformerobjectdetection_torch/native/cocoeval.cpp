// Native COCO-style greedy detection<->gt matching.
//
// The port's copy of panoswintransformerobjectdetection_tpu/native/cocoeval.cpp,
// in the role of mmpycocotools' C extension: the per-(image, class,
// iou-threshold) greedy matching
// loop is the evaluator's hot path; numpy/python does it in interpreted
// O(D*G) loops.  Exposed via a plain C ABI for ctypes (no pybind11 in the
// image).  Build: native/__init__.py (g++ -O3 -shared -fPIC into build/native/).

#include <cstdint>
#include <cstring>

extern "C" {

// det: D x 4 xyxy sorted by score desc; gt: G x 4.
// tp:  D bytes out (1 = matched).
void match_class(const float* det, int32_t D, const float* gt, int32_t G,
                 float iou_thr, uint8_t* tp) {
    uint8_t matched_stack[1024];
    uint8_t* matched = matched_stack;
    bool heap = G > 1024;
    if (heap) matched = new uint8_t[G];
    std::memset(matched, 0, G);
    std::memset(tp, 0, D);

    for (int32_t i = 0; i < D; ++i) {
        const float* d = det + 4 * i;
        float da = (d[2] - d[0]) * (d[3] - d[1]);
        int32_t best_g = -1;
        float best = iou_thr;
        for (int32_t g = 0; g < G; ++g) {
            if (matched[g]) continue;
            const float* gb = gt + 4 * g;
            float x1 = d[0] > gb[0] ? d[0] : gb[0];
            float y1 = d[1] > gb[1] ? d[1] : gb[1];
            float x2 = d[2] < gb[2] ? d[2] : gb[2];
            float y2 = d[3] < gb[3] ? d[3] : gb[3];
            float iw = x2 - x1, ih = y2 - y1;
            if (iw <= 0 || ih <= 0) continue;
            float inter = iw * ih;
            float ga = (gb[2] - gb[0]) * (gb[3] - gb[1]);
            float uni = da + ga - inter;
            float iou = uni > 1e-9f ? inter / uni : 0.f;
            if (iou >= best) { best = iou; best_g = g; }
        }
        if (best_g >= 0) { matched[best_g] = 1; tp[i] = 1; }
    }
    if (heap) delete[] matched;
}

// Batch over iou thresholds: tp is T x D.
void match_class_multi_thr(const float* det, int32_t D, const float* gt,
                           int32_t G, const float* thrs, int32_t T,
                           uint8_t* tp) {
    for (int32_t t = 0; t < T; ++t)
        match_class(det, D, gt, G, thrs[t], tp + (int64_t)t * D);
}

// COCOeval-exact greedy matcher for one (image, category), crowd-aware.
// Mirrors pycocotools COCOeval.evaluateImg matching semantics
// (the protocol behind mmdet/datasets/coco.py:365 of the reference):
//   * detections iterate in score order (rows of `ious`);
//   * a matched non-crowd gt leaves the pool; crowd gt can rematch;
//   * once a det holds a non-ignored match, ignored gts (sorted last)
//     cannot displace it;
//   * ties resolve to the *last* gt whose IoU >= the running best.
// ious: D x G (row-major), gt columns sorted non-ignored-first.
// Outputs: dtm (T x D) matched gt column index or -1; dt_ig (T x D).
void match_image(const double* thrs, int32_t T, const double* ious,
                 int32_t D, int32_t G, const uint8_t* gt_ig,
                 const uint8_t* iscrowd, int64_t* dtm, uint8_t* dt_ig) {
    int64_t* gtm = new int64_t[(int64_t)T * G];
    for (int64_t i = 0; i < (int64_t)T * G; ++i) gtm[i] = -1;
    for (int64_t i = 0; i < (int64_t)T * D; ++i) { dtm[i] = -1; dt_ig[i] = 0; }

    for (int32_t t = 0; t < T; ++t) {
        double thr = thrs[t] < 1.0 - 1e-10 ? thrs[t] : 1.0 - 1e-10;
        int64_t* gtm_t = gtm + (int64_t)t * G;
        for (int32_t d = 0; d < D; ++d) {
            double best = thr;
            int32_t m = -1;
            const double* row = ious + (int64_t)d * G;
            for (int32_t g = 0; g < G; ++g) {
                if (gtm_t[g] >= 0 && !iscrowd[g]) continue;
                if (m > -1 && !gt_ig[m] && gt_ig[g]) break;
                if (row[g] < best) continue;
                best = row[g];
                m = g;
            }
            if (m == -1) continue;
            dt_ig[(int64_t)t * D + d] = gt_ig[m];
            dtm[(int64_t)t * D + d] = m;
            gtm_t[m] = d;
        }
    }
    delete[] gtm;
}

}  // extern "C"
