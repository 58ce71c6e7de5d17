"""Contrastive objectives: inner-product discriminator + expert BCE.

Port of ``noise_gnn_tpu/losses/contrastive.py`` (reference
src/utils/data_utils.py:5-97).
"""

from __future__ import annotations

import torch


def kl_divergence(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Per-sample KL with the reference's 1e-10 guards (data_utils.py:5)."""
    return (p * torch.log((p + 1e-10) / (q + 1e-10))).sum(dim=-1)


def jensen_shannon(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """JS divergence of two probability rows (data_utils.py:9-15)."""
    m = (p + q) / 2.0
    return 0.5 * kl_divergence(p, m) + 0.5 * kl_divergence(q, m)


def discriminator_innerprod(h: torch.Tensor, h_pos: torch.Tensor, h_neg: torch.Tensor):
    """logits = row-wise inner products with the positive / negative views
    (reference Discriminator_innerprod, data_utils.py:53-64)."""
    return (h * h_pos).sum(dim=-1), (h * h_neg).sum(dim=-1)


def discriminator_innerprod2(h: torch.Tensor, h_pos1: torch.Tensor, h_pos2: torch.Tensor,
                             h_neg: torch.Tensor):
    """Two-positive variant (data_utils.py:85-97)."""
    return (h * h_pos1).sum(dim=-1), (h * h_pos2).sum(dim=-1), (h * h_neg).sum(dim=-1)


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                     weights: torch.Tensor | None) -> torch.Tensor:
    per = logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    if weights is None:
        return per.mean()
    w = weights.float()
    return (per * w).sum() / w.sum().clamp(min=1.0)


def bce_expert_loss(logits_pos: torch.Tensor, logits_neg: torch.Tensor,
                    pos_mask: torch.Tensor | None = None,
                    neg_mask: torch.Tensor | None = None) -> torch.Tensor:
    """BCE(positives vs 1) + BCE(negatives vs 0) (reference BCEExeprtLoss,
    data_utils.py:34-50); a mask selects the rows each mean runs over."""
    lp = _bce_with_logits(logits_pos, torch.ones_like(logits_pos), pos_mask)
    ln = _bce_with_logits(logits_neg, torch.zeros_like(logits_neg), neg_mask)
    return lp + ln


def bce_expert_loss2(logits_pos1: torch.Tensor, logits_pos2: torch.Tensor,
                     logits_neg: torch.Tensor, pos_mask: torch.Tensor | None = None,
                     neg_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Two-positive variant (reference BCEExeprtLoss2 intent,
    data_utils.py:66-83, with its __init__ super-call bug fixed as the JAX
    package fixes it)."""
    pos = torch.cat([logits_pos1, logits_pos2])
    pm = None if pos_mask is None else torch.cat([pos_mask, pos_mask])
    lp = _bce_with_logits(pos, torch.ones_like(pos), pm)
    ln = _bce_with_logits(logits_neg, torch.zeros_like(logits_neg), neg_mask)
    return lp + ln


def topk_accuracy(logits: torch.Tensor, targets: torch.Tensor,
                  topk: tuple[int, ...] = (1,)) -> list[torch.Tensor]:
    """precision@k (reference topk_accuracy, data_utils.py:17-32); equal
    logits rank in index order, as ``jax.lax.top_k`` ranks them."""
    pred = torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :max(topk)]
    correct = pred == targets[:, None]
    return [100.0 * correct[:, :k].any(dim=-1).float().mean() for k in topk]
