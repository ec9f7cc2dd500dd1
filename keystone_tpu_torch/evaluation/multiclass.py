"""Multiclass evaluation (counterpart of keystone_tpu/evaluation/multiclass.py)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class BinaryClassificationMetrics:
    tp: float
    fp: float
    tn: float
    fn: float

    def merge(self, o: "BinaryClassificationMetrics"):
        return BinaryClassificationMetrics(
            self.tp + o.tp, self.fp + o.fp, self.tn + o.tn, self.fn + o.fn
        )

    @property
    def accuracy(self):
        return (self.tp + self.tn) / (self.tp + self.fp + self.tn + self.fn)

    @property
    def error(self):
        return (self.fp + self.fn) / (self.tp + self.fp + self.tn + self.fn)

    @property
    def recall(self):
        return self.tp / (self.tp + self.fn)

    @property
    def precision(self):
        return self.tp / (self.tp + self.fp)

    @property
    def specificity(self):
        return self.tn / (self.fp + self.tn)

    def f_score(self, beta: float = 1.0) -> float:
        num = (1.0 + beta * beta) * self.tp
        denom = (1.0 + beta * beta) * self.tp + beta * beta * self.fn + self.fp
        return num / denom


class MulticlassMetrics:
    """Confusion-matrix metrics; rows = true labels, cols = predicted."""

    def __init__(self, confusion_matrix):
        cm = np.asarray(confusion_matrix, dtype=np.float64)
        if cm.shape[0] != cm.shape[1]:
            raise ValueError("Confusion matrix must be square")
        self.confusion_matrix = cm
        self.num_classes = cm.shape[0]
        total = cm.sum()
        actual_sums = cm.sum(axis=1)
        predicted_sums = cm.sum(axis=0)
        self.class_metrics = []
        for c in range(self.num_classes):
            tp = cm[c, c]
            fp = predicted_sums[c] - tp
            tn = total - actual_sums[c] - fp
            fn = total - tp - fp - tn
            self.class_metrics.append(BinaryClassificationMetrics(tp, fp, tn, fn))

    def _class_avg(self, f) -> float:
        return sum(f(m) for m in self.class_metrics) / self.num_classes

    def _micro(self, f) -> float:
        merged = self.class_metrics[0]
        for m in self.class_metrics[1:]:
            merged = merged.merge(m)
        return f(merged)

    @property
    def avg_accuracy(self):
        return self._class_avg(lambda m: m.accuracy)

    @property
    def avg_error(self):
        return self._class_avg(lambda m: m.error)

    @property
    def macro_precision(self):
        return self._class_avg(lambda m: m.precision)

    @property
    def macro_recall(self):
        return self._class_avg(lambda m: m.recall)

    def macro_f_score(self, beta: float = 1.0):
        return self._class_avg(lambda m: m.f_score(beta))

    @property
    def total_accuracy(self):
        return self._micro(lambda m: m.precision)

    @property
    def total_error(self):
        return self._micro(lambda m: m.fn / (m.fn + m.tp))

    @property
    def micro_precision(self):
        return self._micro(lambda m: m.precision)

    @property
    def micro_recall(self):
        return self._micro(lambda m: m.recall)

    def micro_f_score(self, beta: float = 1.0):
        return self._micro(lambda m: m.f_score(beta))

    def pprint_confusion_matrix(self, classes) -> str:
        """Mahout-style table: one row per actual class, one column per
        predicted class, headed by base-26 column labels."""
        labels = [_small_label(i) for i in range(self.num_classes)]
        width = max(6, max(len(l) for l in labels) + 1)
        lines = ["".join(l.rjust(width) for l in labels) + "   <-- Classified As"]
        for r in range(self.num_classes):
            row = "".join(
                str(int(self.confusion_matrix[r, c])).rjust(width)
                for c in range(self.num_classes)
            )
            lines.append(f"{row}   {labels[r]} = {classes[r]}")
        return "\n".join(lines)

    def summary(self, classes) -> str:
        return (
            f"{self.pprint_confusion_matrix(classes)}\n"
            f"Avg Accuracy:\t{self.avg_accuracy:2.3f}\n"
            f"Macro Precision:\t{self.macro_precision:2.3f}\n"
            f"Macro Recall:\t{self.macro_recall:2.3f}\n"
            f"Macro F1:\t{self.macro_f_score():2.3f}\n"
            f"Total Accuracy:\t{self.total_accuracy:2.3f}\n"
            f"Micro Precision:\t{self.micro_precision:2.3f}\n"
            f"Micro Recall:\t{self.micro_recall:2.3f}\n"
            f"Micro F1:\t{self.micro_f_score():2.3f}\n"
        )


def _small_label(i: int) -> str:
    """Base-26 column header with the reference's digit order (least
    significant first) and its off-by-one, so printed headers match."""
    if i == 0:
        return "a"
    out = ""
    while i > 0:
        out = out + chr(ord("a") + (i % 26))
        i //= 26
    return out


def confusion_matrix(predictions, actuals, num_classes: int) -> torch.Tensor:
    """Confusion matrix in one bincount: rows = actual, cols = predicted."""
    predictions = torch.as_tensor(predictions).to(torch.long)
    actuals = torch.as_tensor(actuals).to(device=predictions.device, dtype=torch.long)
    flat = actuals * num_classes + predictions
    counts = torch.bincount(flat, minlength=num_classes * num_classes)
    return counts.reshape(num_classes, num_classes)


class MulticlassClassifierEvaluator:
    """``MulticlassClassifierEvaluator(predictions, actuals, k)`` returns the
    :class:`MulticlassMetrics` of the pair."""

    @staticmethod
    def apply(predictions, actuals, num_classes: int) -> MulticlassMetrics:
        cm = confusion_matrix(predictions, actuals, num_classes)
        return MulticlassMetrics(cm.cpu().numpy())

    def __new__(cls, predictions, actuals, num_classes: int) -> MulticlassMetrics:  # type: ignore[misc]
        return cls.apply(predictions, actuals, num_classes)


class BinaryClassifierEvaluator:
    """``BinaryClassifierEvaluator(predictions, actuals)`` returns the
    contingency table of two boolean vectors (tensors on any device, or
    arrays) as :class:`BinaryClassificationMetrics`."""

    @staticmethod
    def apply(predictions, actuals) -> BinaryClassificationMetrics:
        p = torch.as_tensor(predictions).to(torch.bool)
        a = torch.as_tensor(actuals).to(device=p.device, dtype=torch.bool)
        counts = torch.stack([m.sum() for m in (p & a, p & ~a, ~p & ~a, ~p & a)])
        return BinaryClassificationMetrics(*(float(c) for c in counts.tolist()))

    def __new__(cls, predictions, actuals) -> BinaryClassificationMetrics:  # type: ignore[misc]
        return cls.apply(predictions, actuals)
