"""Evaluation metrics — accuracy / weighted F1 / precision / recall.

Same semantics as the reference's sklearn-backed compute_metrics
(evaluate.py:23-59): single-column outputs are thresholded at 0.5 (binary
path, targets also thresholded), multi-column outputs argmax; precision/
recall/F1 are support-weighted with zero-division → 0. Implemented in pure
numpy so evaluation can run in environments without sklearn; validated
against sklearn in tests/test_metrics.py when it is available.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _weighted_prf(targets: np.ndarray, preds: np.ndarray):
    classes = np.unique(targets)
    total = targets.size
    precision = recall = f1 = 0.0
    for c in classes:
        support = np.sum(targets == c)
        tp = np.sum((preds == c) & (targets == c))
        fp = np.sum((preds == c) & (targets != c))
        fn = np.sum((preds != c) & (targets == c))
        p = tp / (tp + fp) if (tp + fp) > 0 else 0.0
        r = tp / (tp + fn) if (tp + fn) > 0 else 0.0
        f = 2 * p * r / (p + r) if (p + r) > 0 else 0.0
        w = support / total
        precision += w * p
        recall += w * r
        f1 += w * f
    return precision, recall, f1


def compute_metrics(outputs, targets) -> Dict[str, float]:
    """outputs: (N, C) or (N,) scores; targets: (N,) labels.

    Returns {"acc", "f1", "precision", "recall"} exactly like the
    reference's metric dict.
    """
    outputs = np.asarray(outputs)
    targets = np.asarray(targets).reshape(-1)
    if outputs.ndim == 1:
        outputs = outputs.reshape(-1, 1)

    if outputs.shape[1] == 1:
        preds = (outputs[:, 0] > 0.5).astype(np.int64)
        targets = (targets > 0.5).astype(np.int64)
    else:
        preds = outputs.argmax(axis=1).astype(np.int64)
        targets = targets.astype(np.int64)

    acc = float(np.mean(preds == targets)) if targets.size else 0.0
    precision, recall, f1 = _weighted_prf(targets, preds)
    return {
        "acc": acc,
        "f1": float(f1),
        "precision": float(precision),
        "recall": float(recall),
    }
