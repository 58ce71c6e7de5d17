"""Accuracy metrics with reference parity.

Port of ``noise_gnn_tpu/eval/metrics.py``. The reference evaluates with the
OGB Evaluator for ogbn datasets (src/pipeline.py:184-195) and sklearn
accuracy otherwise (src/pipeline_s.py:181-183); both are plain top-1
accuracy over the split indices, so one implementation serves both.
"""

from __future__ import annotations

import numpy as np
import torch


def accuracy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    if y_true.size == 0:
        return float("nan")
    return float((y_true == y_pred).mean())


def evaluate_splits(logits: torch.Tensor, y_true: np.ndarray, split_idx: dict) -> dict:
    """{'train','valid','test'} top-1 accuracy from full-graph logits."""
    pred = logits.argmax(dim=-1).cpu().numpy()
    y_true = np.asarray(y_true).reshape(-1)
    return {part: accuracy(y_true[idx], pred[idx]) for part, idx in split_idx.items()}


def confusion_matrix(y_true: np.ndarray, y_pred: np.ndarray, num_classes: int) -> np.ndarray:
    """Multiclass confusion matrix (reference PipelineA uses torcheval's,
    src/pipeline_analysis.py:227)."""
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    cm = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(cm, (y_true, y_pred), 1)
    return cm
