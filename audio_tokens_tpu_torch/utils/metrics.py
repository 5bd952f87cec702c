"""Evaluation metrics.

A copy of ``audio_tokens_tpu/utils/metrics.py``, held equal to the original by
``tests/test_torch_train_data.py``.

Macro mean-average-precision over classes that have at least one positive in
the evaluated set — the reference's headline metric
(reference: utils/metrics_calculator.py:8-33, which delegates per-class AP to
sklearn.average_precision_score).  Implemented here in pure numpy with the
same step-interpolation and tie handling as sklearn so scores are directly
comparable; verified against sklearn in tests/test_metrics.py.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def binary_average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """AP = sum_n (R_n - R_{n-1}) * P_n over distinct-score thresholds.

    Matches sklearn.metrics.average_precision_score for binary labels,
    including tie grouping (all samples sharing a score fall under one
    threshold).
    """
    y_true = np.asarray(y_true, dtype=np.float64).ravel()
    y_score = np.asarray(y_score, dtype=np.float64).ravel()
    n_pos = y_true.sum()
    if n_pos == 0:
        return 0.0

    order = np.argsort(-y_score, kind="stable")
    y_true = y_true[order]
    y_score = y_score[order]

    # Last index of each run of equal scores = the distinct thresholds.
    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_true.size - 1]

    tps = np.cumsum(y_true)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    precision = tps / (tps + fps)
    recall = tps / n_pos

    prev_recall = np.r_[0.0, recall[:-1]]
    return float(np.sum((recall - prev_recall) * precision))


def macro_mean_average_precision(
    labels: np.ndarray, predictions: np.ndarray
) -> float:
    """Mean AP over classes with >=1 positive (reference: utils/metrics_calculator.py:25-33)."""
    labels = np.asarray(labels)
    predictions = np.asarray(predictions)
    aps = [
        binary_average_precision(labels[:, i], predictions[:, i])
        for i in range(labels.shape[1])
        if labels[:, i].sum() > 0
    ]
    return float(np.mean(aps)) if aps else 0.0


class StreamingMAP:
    """Constant-memory macro mAP via per-class score histograms.

    Exact AP needs the full score ordering per class; at the 2M-clip scale
    that is ~4.3 GB of stored sigmoids per epoch.  Binning scores (sigmoids
    live in [0, 1]) into ``bins`` buckets computes AP from (positive,
    negative) counts per bucket — O(classes x bins) memory, independent of
    the number of evaluated clips, with binning error O(1/bins).  Each
    bucket acts as one tied-score threshold group, the same tie semantics
    sklearn/`binary_average_precision` use for exactly-equal scores.
    """

    def __init__(self, num_classes: int, bins: int = 8192):
        self.bins = bins
        self.num_classes = num_classes
        self.pos = np.zeros((num_classes, bins), np.int64)
        self.neg = np.zeros((num_classes, bins), np.int64)

    def update(self, labels: np.ndarray, scores: np.ndarray) -> None:
        """labels (N, C) {0,1}; scores (N, C) in [0, 1]."""
        labels = np.asarray(labels)
        scores = np.asarray(scores)
        if labels.size == 0:
            return
        c = self.num_classes
        idx = np.clip((scores * self.bins).astype(np.int64), 0, self.bins - 1)
        flat = (np.arange(c)[None, :] * self.bins + idx).ravel()
        is_pos = labels.ravel() > 0.5
        size = c * self.bins
        self.pos += np.bincount(flat[is_pos], minlength=size).reshape(c, -1)
        self.neg += np.bincount(flat[~is_pos], minlength=size).reshape(c, -1)

    def result(self) -> Dict[str, float]:
        # traverse buckets high-score -> low; every non-empty bucket is one
        # threshold (empty buckets contribute zero recall delta)
        tps = np.cumsum(self.pos[:, ::-1], axis=1).astype(np.float64)
        fps = np.cumsum(self.neg[:, ::-1], axis=1).astype(np.float64)
        n_pos = tps[:, -1]
        valid = n_pos > 0
        if not valid.any():
            return {"mAP": 0.0}
        precision = tps / np.maximum(tps + fps, 1.0)
        recall = tps / np.maximum(n_pos[:, None], 1.0)
        delta_r = np.diff(recall, axis=1, prepend=0.0)
        aps = np.sum(delta_r * precision, axis=1)
        return {"mAP": float(np.mean(aps[valid]))}


class ExactMAP:
    """Accumulator facade over the exact mAP (stores every score)."""

    def __init__(self):
        self.preds: List[np.ndarray] = []
        self.labels: List[np.ndarray] = []

    def update(self, labels: np.ndarray, scores: np.ndarray) -> None:
        self.labels.append(np.asarray(labels))
        self.preds.append(np.asarray(scores))

    def result(self) -> Dict[str, float]:
        return MetricsCalculator().compute_metrics(self.preds, self.labels)


class MetricsCalculator:
    """Drop-in equivalent of the reference's MetricsCalculator."""

    def compute_metrics(
        self, predictions: Sequence[np.ndarray], labels: Sequence[np.ndarray]
    ) -> Dict[str, float]:
        predictions = list(predictions)
        labels = list(labels)
        if not predictions or not labels:
            return {"mAP": 0.0}  # empty split: defined, not a crash
        all_predictions = np.concatenate(predictions, axis=0)
        all_labels = np.concatenate(labels, axis=0)
        return {"mAP": macro_mean_average_precision(all_labels, all_predictions)}
