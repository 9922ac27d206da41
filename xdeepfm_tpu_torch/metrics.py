"""Metrics (port of ``xdeepfm_tpu/metrics.py``).

* Host-exact: ``evaluate()`` pools predictions on the host and scores them
  with sklearn's semantics (tie-aware AUC, clipped logloss).
* Device, masked: ``fit`` scores each padded batch on the device with the
  ``batch_*`` functions (``DEVICE_METRICS``); padded rows carry mask 0.
"""

from __future__ import annotations

import numpy as np
import torch


def roc_auc_score(y_true, y_score):
    """Exact AUC with average ranks for ties (== sklearn.roc_auc_score).

    2D [N, T] inputs -> macro average over columns (sklearn multilabel
    behavior, used by the reference's multitask evaluate path)."""
    y_true = np.asarray(y_true)
    y_score = np.asarray(y_score)
    if y_true.ndim == 2 and y_true.shape[1] > 1:
        return float(
            np.mean(
                [
                    roc_auc_score(y_true[:, i], y_score[:, i])
                    for i in range(y_true.shape[1])
                ]
            )
        )
    y_true = y_true.reshape(-1)
    y_score = y_score.reshape(-1)
    pos = y_true > 0.5
    n_pos = int(pos.sum())
    n_neg = len(y_true) - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError(
            "Only one class present in y_true. ROC AUC score is not defined."
        )
    sorted_scores = np.sort(y_score, kind="mergesort")
    # average rank (1-based) per element, ties averaged
    lo = np.searchsorted(sorted_scores, y_score, side="left")
    hi = np.searchsorted(sorted_scores, y_score, side="right")
    ranks = (lo + hi + 1) / 2.0
    return (ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)


def log_loss(y_true, y_pred, eps=1e-15):
    y_true = np.asarray(y_true, dtype=np.float64).reshape(-1)
    y_pred = np.clip(np.asarray(y_pred, dtype=np.float64).reshape(-1), eps, 1 - eps)
    return float(
        -np.mean(y_true * np.log(y_pred) + (1 - y_true) * np.log(1 - y_pred))
    )


def mean_squared_error(y_true, y_pred):
    y_true = np.asarray(y_true, dtype=np.float64).reshape(-1)
    y_pred = np.asarray(y_pred, dtype=np.float64).reshape(-1)
    return float(np.mean((y_true - y_pred) ** 2))


def accuracy_score(y_true, y_pred):
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    return float(np.mean((y_pred > 0.5).astype(np.int32) == y_true.astype(np.int32)))


HOST_METRICS = {
    "binary_crossentropy": log_loss,
    "logloss": log_loss,
    "auc": roc_auc_score,
    "mse": mean_squared_error,
    "accuracy": accuracy_score,
    "acc": accuracy_score,
}


# ---------------------------------------------------------------------------
# Device (torch, masked) — per-batch train metrics, no host sync.
# ---------------------------------------------------------------------------


def batch_auc(y_true, y_score, mask):
    """Tie-aware AUC over the valid entries of a padded batch.

    Padded entries get score -inf (below any finite prediction) and weight
    0; they inflate every valid rank by exactly n_pad, which cancels in the
    formula.  0.5 when the batch holds one class only."""
    y_true = y_true.reshape(-1)
    mask = mask.reshape(-1)
    score = torch.where(mask > 0, y_score.reshape(-1), -torch.inf)
    sorted_scores = torch.sort(score).values
    lo = torch.searchsorted(sorted_scores, score, side="left")
    hi = torch.searchsorted(sorted_scores, score, side="right")
    ranks = (lo + hi + 1) / 2.0
    n_pad = (mask <= 0).sum()
    pos_w = mask * (y_true > 0.5)
    n_pos = pos_w.sum()
    n_neg = mask.sum() - n_pos
    sum_ranks_pos = (ranks * pos_w).sum()
    denom = n_pos * n_neg
    auc = (sum_ranks_pos - n_pos * n_pad - n_pos * (n_pos + 1) / 2.0) / torch.where(
        denom > 0, denom, 1.0
    )
    return torch.where(denom > 0, auc, 0.5)


def batch_log_loss(y_true, y_pred, mask, eps=1e-15):
    y_true = y_true.reshape(-1)
    p = y_pred.reshape(-1).clamp(eps, 1 - eps)
    mask = mask.reshape(-1)
    ll = -(y_true * torch.log(p) + (1 - y_true) * torch.log(1 - p))
    return (ll * mask).sum() / mask.sum().clamp(min=1.0)


def batch_mse(y_true, y_pred, mask):
    mask = mask.reshape(-1)
    err = y_true.reshape(-1) - y_pred.reshape(-1)
    return (mask * err**2).sum() / mask.sum().clamp(min=1.0)


def batch_accuracy(y_true, y_pred, mask):
    mask = mask.reshape(-1)
    correct = ((y_pred.reshape(-1) > 0.5) == (y_true.reshape(-1) > 0.5)).float()
    return (correct * mask).sum() / mask.sum().clamp(min=1.0)


DEVICE_METRICS = {
    "binary_crossentropy": batch_log_loss,
    "logloss": batch_log_loss,
    "auc": batch_auc,
    "mse": batch_mse,
    "accuracy": batch_accuracy,
    "acc": batch_accuracy,
}
