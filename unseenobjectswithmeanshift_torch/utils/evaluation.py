"""Instance-segmentation evaluation: Objects / Boundary Precision-Recall-F.

Port of ``unseenobjectswithmeanshift_tpu.utils.evaluation`` (ref:
lib/utils/evaluation.py), held equal to it bit for bit: the same integer
counts, then the same float64 operations in the same order, scipy's
``linear_sum_assignment`` on ``F.max() - F``. Two changes of mechanism:

- the counts of a (gt, pred) label pair (intersection, sizes, the dilated
  boundary overlaps) come from each label's mask, boundary and dilation
  computed once, not once a pair, in the port's native library
  (``pairwise_mask_stats``, ``pairwise_boundary_counts``).
  ``backend="numpy"`` counts with numpy instead: the plain twin that the
  tests hold the native counts against;
- the dilation uses no cv2: ``scipy.ndimage.binary_dilation`` with the same
  disk (cv2's default border adds nothing to a binary dilation, nor does
  scipy's zero border), on the label's bounding box grown by the radius.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage
from scipy.optimize import linear_sum_assignment

from .. import native

BACKGROUND_LABEL = 0
OBJECTS_LABEL = 1
BOUND_TH = 0.003


def disk(radius: int) -> np.ndarray:
    """Boolean disk structuring element, identical to skimage.morphology.disk."""
    L = np.arange(-radius, radius + 1)
    x, y = np.meshgrid(L, L)
    return ((x ** 2 + y ** 2) <= radius ** 2).astype(np.uint8)


def seg2bmap(seg: np.ndarray) -> np.ndarray:
    """1-pixel-wide binary boundary map of a binary segmentation.

    Boundary pixels are offset 1/2 px towards the origin from the true segment
    boundary (ref: lib/utils/evaluation.py:15-72, David Martin's bmap).
    """
    seg = seg.astype(bool)

    e = np.zeros_like(seg)
    s = np.zeros_like(seg)
    se = np.zeros_like(seg)

    e[:, :-1] = seg[:, 1:]
    s[:-1, :] = seg[1:, :]
    se[:-1, :-1] = seg[1:, 1:]

    b = (seg ^ e) | (seg ^ s) | (seg ^ se)
    b[-1, :] = seg[-1, :] ^ e[-1, :]
    b[:, -1] = seg[:, -1] ^ s[:, -1]
    b[-1, -1] = False
    return b


def bound_pixels(shape, bound_th: float = BOUND_TH) -> int:
    return int(bound_th if bound_th >= 1 else np.ceil(bound_th * np.linalg.norm(shape)))


def dilate(bmap: np.ndarray, radius: int) -> np.ndarray:
    """Binary dilation by disk(radius) with nothing beyond the border, as
    cv2.dilate's default border gives: computed on the map's bounding box
    grown by the radius (nothing outside it can be reached)."""
    out = np.zeros_like(bmap, dtype=bool)
    ys, xs = np.nonzero(bmap)
    if ys.size == 0:
        return out
    h, w = bmap.shape
    y0, y1 = max(ys.min() - radius, 0), min(ys.max() + radius + 1, h)
    x0, x1 = max(xs.min() - radius, 0), min(xs.max() + radius + 1, w)
    out[y0:y1, x0:x1] = ndimage.binary_dilation(bmap[y0:y1, x0:x1],
                                                structure=disk(radius).astype(bool))
    return out


def boundary_overlap(predicted_mask: np.ndarray, gt_mask: np.ndarray,
                     bound_th: float = BOUND_TH, backend: str = "native"):
    """True positives of dilated boundaries: (precision_tps, recall_tps).

    Ref: lib/utils/evaluation.py:75-106.
    """
    native.check_backend(backend)
    r = bound_pixels(predicted_mask.shape, bound_th)
    if backend == "native":
        return native.boundary_overlap_counts(predicted_mask, gt_mask, r)
    fg_boundary = seg2bmap(predicted_mask)
    gt_boundary = seg2bmap(gt_mask)
    fg_match = np.logical_and(fg_boundary, dilate(gt_boundary, r))
    gt_match = np.logical_and(gt_boundary, dilate(fg_boundary, r))
    return int(np.sum(fg_match)), int(np.sum(gt_match))


def pair_counts(prediction, gt, labels_gt, labels_pred, backend: str = "native"):
    """The integer counts of every (gt label i, pred label j) pair:
    (inter [ng, np], gt sizes [ng], pred sizes [np], boundary overlaps
    [ng, np, 2] = boundary_overlap(pred == j, gt == i), boundary sizes of
    the pred labels [np] and of the gt labels [ng]), all int64."""
    native.check_backend(backend)
    r = bound_pixels(prediction.shape)
    if backend == "native":
        inter, gsz, psz = native.pairwise_mask_stats(prediction, gt, labels_gt, labels_pred)
        bounds, gb, pb = native.pairwise_boundary_counts(prediction, gt, labels_gt,
                                                         labels_pred, r)
        return inter, gsz, psz, bounds, pb, gb
    gmask = [gt == g for g in labels_gt]
    pmask = [prediction == p for p in labels_pred]
    gbmap = [seg2bmap(m) for m in gmask]
    pbmap = [seg2bmap(m) for m in pmask]
    gdil = [dilate(b, r) for b in gbmap]
    pdil = [dilate(b, r) for b in pbmap]
    ng, npred = len(gmask), len(pmask)
    inter = np.zeros((ng, npred), np.int64)
    bounds = np.zeros((ng, npred, 2), np.int64)
    for i in range(ng):
        for j in range(npred):
            inter[i, j] = np.count_nonzero(np.logical_and(pmask[j], gmask[i]))
            bounds[i, j] = (np.count_nonzero(np.logical_and(pbmap[j], gdil[i])),
                            np.count_nonzero(np.logical_and(gbmap[i], pdil[j])))
    sizes = lambda ms: np.array([np.count_nonzero(m) for m in ms], np.int64)
    return inter, sizes(gmask), sizes(pmask), bounds, sizes(pbmap), sizes(gbmap)


def _edge_case(num_labels_pred, num_labels_gt):
    """The reference's constants where either side has no object."""
    if num_labels_pred == 0 and num_labels_gt > 0:  # all false negatives
        return {
            "Objects F-measure": 0.0, "Objects Precision": 1.0, "Objects Recall": 0.0,
            "Boundary F-measure": 0.0, "Boundary Precision": 1.0, "Boundary Recall": 0.0,
            "obj_detected": num_labels_pred, "obj_detected_075": 0.0,
            "obj_gt": num_labels_gt, "obj_detected_075_percentage": 0.0,
        }
    if num_labels_pred > 0 and num_labels_gt == 0:  # all false positives
        return {
            "Objects F-measure": 0.0, "Objects Precision": 0.0, "Objects Recall": 1.0,
            "Boundary F-measure": 0.0, "Boundary Precision": 0.0, "Boundary Recall": 1.0,
            "obj_detected": num_labels_pred, "obj_detected_075": 0.0,
            "obj_gt": num_labels_gt, "obj_detected_075_percentage": 0.0,
        }
    if num_labels_pred == 0 and num_labels_gt == 0:  # correctly predicted nothing
        return {
            "Objects F-measure": 1.0, "Objects Precision": 1.0, "Objects Recall": 1.0,
            "Boundary F-measure": 1.0, "Boundary Precision": 1.0, "Boundary Recall": 1.0,
            "obj_detected": num_labels_pred, "obj_detected_075": 0.0,
            "obj_gt": num_labels_gt, "obj_detected_075_percentage": 1.0,
        }
    return None


def multilabel_metrics(prediction: np.ndarray, gt: np.ndarray,
                       obj_detect_threshold: float = 0.75, backend: str = "native") -> dict:
    """Overlap and Boundary P/R/F over object labels (every nonzero label of
    prediction and gt; ref: lib/utils/evaluation.py:109-258)."""
    labels_gt = np.unique(gt)
    labels_gt = labels_gt[~np.isin(labels_gt, [BACKGROUND_LABEL])]
    num_labels_gt = labels_gt.shape[0]

    labels_pred = np.unique(prediction)
    labels_pred = labels_pred[~np.isin(labels_pred, [BACKGROUND_LABEL])]
    num_labels_pred = labels_pred.shape[0]

    edge = _edge_case(num_labels_pred, num_labels_gt)
    if edge is not None:
        return edge

    inter, gt_sizes, pred_sizes, bounds, pred_bsizes, gt_bsizes = pair_counts(
        prediction, gt, labels_gt, labels_pred, backend=backend)
    # the JAX loop's float64 arithmetic, elementwise in its order
    true_positives = inter.astype(np.float64)
    prec = inter / pred_sizes[None, :]
    rec = inter / gt_sizes[:, None]
    ok = prec + rec > 0
    F = np.zeros((num_labels_gt, num_labels_pred))
    with np.errstate(invalid="ignore"):            # 0 / 0 where ok is False
        F[ok] = ((2 * prec * rec) / (prec + rec))[ok]
    boundary_stuff = bounds.astype(np.float64)

    boundary_prec_denom = sum(int(v) for v in pred_bsizes)
    boundary_rec_denom = sum(int(v) for v in gt_bsizes)

    F[np.isnan(F)] = 0
    row, col = linear_sum_assignment(F.max() - F)
    idx = (row, col)

    num_obj_detected = int(np.sum(F[idx] > obj_detect_threshold))

    precision = np.sum(true_positives[idx]) / np.sum(prediction.clip(0, 1) == OBJECTS_LABEL)
    recall = np.sum(true_positives[idx]) / np.sum(gt.clip(0, 1) == OBJECTS_LABEL)
    F_measure = (2 * precision * recall) / (precision + recall + 1e-10)
    if np.isnan(F_measure):
        F_measure = 0.0

    boundary_precision = np.sum(boundary_stuff[idx][:, 0]) / boundary_prec_denom
    boundary_recall = np.sum(boundary_stuff[idx][:, 1]) / boundary_rec_denom
    boundary_F_measure = (2 * boundary_precision * boundary_recall) / (
        boundary_precision + boundary_recall + 1e-10
    )
    if np.isnan(boundary_F_measure):
        boundary_F_measure = 0.0

    return {
        "Objects F-measure": float(F_measure),
        "Objects Precision": float(precision),
        "Objects Recall": float(recall),
        "Boundary F-measure": float(boundary_F_measure),
        "Boundary Precision": float(boundary_precision),
        "Boundary Recall": float(boundary_recall),
        "obj_detected": int(num_labels_pred),
        "obj_detected_075": num_obj_detected,
        "obj_gt": int(num_labels_gt),
        "obj_detected_075_percentage": num_obj_detected / num_labels_gt,
    }


METRIC_PRINT_ORDER = [
    "Objects Precision", "Objects Recall", "Objects F-measure",
    "Boundary Precision", "Boundary Recall", "Boundary F-measure",
    "obj_detected_075_percentage",
]


def aggregate_metrics(metrics_list) -> dict:
    """Average a list of per-image metric dicts (ref: test_utils.py:439-457)."""
    result = {}
    n = len(metrics_list)
    for metrics in metrics_list:
        for k, v in metrics.items():
            result[k] = result.get(k, 0) + v
    return {k: v / n for k, v in result.items()}


def format_metrics(result: dict) -> str:
    lines = []
    for k in sorted(result.keys()):
        lines.append("%s: %f" % (k, result[k]))
    for k in METRIC_PRINT_ORDER:
        if k in result:
            lines.append("%.6f" % result[k])
    return "\n".join(lines)


def print_metrics(result: dict) -> str:
    out = format_metrics(result)
    print(out)
    return out


def save_result_mat(path: str, labels, labels_refined, filename: str):
    """Persist per-image results as .mat (ref: test_segnet,
    lib/fcn/test_dataset.py:337-340)."""
    import scipy.io

    scipy.io.savemat(path, {"labels": labels, "labels_refined": labels_refined,
                            "filename": filename}, do_compression=True)
