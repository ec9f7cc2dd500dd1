"""VOC-style mean average precision (counterpart of
keystone_tpu/evaluation/map.py): 11-point interpolated AP per class, the
precision maxima at recall levels 0, 0.1, ..., 1.0, averaged by the caller.
"""

from __future__ import annotations

import numpy as np


def mean_average_precision(test_actual, test_predicted, num_classes: int) -> np.ndarray:
    """``test_actual``: per-example list/array of true class ids;
    ``test_predicted``: [N, num_classes] scores.  Returns per-class AP [C]."""
    scores = np.asarray(test_predicted, np.float64)
    n = scores.shape[0]
    gt = np.zeros((n, num_classes), np.float64)
    for i, labels in enumerate(test_actual):
        for label in np.atleast_1d(np.asarray(labels)):
            if label >= 0:
                gt[i, int(label)] = 1.0

    aps = np.zeros(num_classes)
    for cl in range(num_classes):
        order = np.argsort(-scores[:, cl], kind="stable")
        g = gt[order, cl]
        tps = np.cumsum(g)
        fps = np.cumsum(1.0 - g)
        total = gt[:, cl].sum()
        if total == 0:
            aps[cl] = 0.0
            continue
        recalls = tps / total
        precisions = tps / (tps + fps)
        ap = 0.0
        # Exact levels x/10: accumulating 0.1 steps would give
        # 0.30000000000000004 and miss exact-recall hits.
        for t in np.arange(11) / 10.0:
            px = precisions[recalls >= t]
            ap += (px.max() if px.size else 0.0) / 11.0
        aps[cl] = ap
    return aps


MeanAveragePrecisionEvaluator = mean_average_precision
