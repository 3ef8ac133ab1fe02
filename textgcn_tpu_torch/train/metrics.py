"""Evaluation metrics on tensors.

Port of ``textgcn_tpu/train/metrics.py``, with the reference's conventions:
accuracy = mean(argmax(logits) == target); macro P and R from per-class
TP/FP/FN with 0 for an empty class; and F1 computed **from the macro P and R**
(not the mean of per-class F1s), kept for comparability with the reference.
"""
from __future__ import annotations

from typing import Tuple

import torch


def accuracy(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=1) == target).float().mean()


def confusion_counts(
    logits: torch.Tensor, target: torch.Tensor, num_classes: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-class (TP, FP, FN) as float32 [C] tensors."""
    pred_1h = torch.nn.functional.one_hot(logits.argmax(dim=1), num_classes).float()
    targ_1h = torch.nn.functional.one_hot(target.long(), num_classes).float()
    tp = (pred_1h * targ_1h).sum(dim=0)
    fp = (pred_1h * (1.0 - targ_1h)).sum(dim=0)
    fn = ((1.0 - pred_1h) * targ_1h).sum(dim=0)
    return tp, fp, fn


def macro_f1(
    logits: torch.Tensor, target: torch.Tensor, num_classes: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Return (f1, macro_precision, macro_recall), reference convention."""
    tp, fp, fn = confusion_counts(logits, target, num_classes)
    prec = torch.where(tp + fp > 0, tp / (tp + fp).clamp(min=1.0), 0.0)
    rec = torch.where(tp + fn > 0, tp / (tp + fn).clamp(min=1.0), 0.0)
    p = prec.mean()
    r = rec.mean()
    f1 = torch.where(p + r > 0, 2.0 * p * r / (p + r).clamp(min=1e-30), 0.0)
    return f1, p, r
