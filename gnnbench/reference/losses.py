"""Co-teaching's small-loss exchange (reference CTLoss, src/utils/losses.py)
and the TE contrast's inner-product discriminator with the experts' BCE
(src/utils/data_utils.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -F.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]


def _rank(v: torch.Tensor) -> torch.Tensor:
    order = torch.argsort(v, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(v.shape[0], device=v.device)
    return rank


def ct_loss(o1, o2, y, forget_rate: float, mask):
    """(loss_1, loss_2, keep_1, keep_2): each net keeps the
    floor((1 - forget_rate) n_valid) valid samples of smallest CE (ties to
    the lower index), and each net's loss is its CE over the OTHER net's
    selection, divided by the number kept."""
    ce1, ce2 = cross_entropy(o1, y), cross_entropy(o2, y)
    big = torch.finfo(torch.float32).max / 2
    n_keep = torch.floor((1.0 - torch.tensor(forget_rate, dtype=torch.float32, device=y.device))
                         * mask.sum() + 1e-4)
    keep1 = (_rank(torch.where(mask, ce1.detach(), big)) < n_keep) & mask
    keep2 = (_rank(torch.where(mask, ce2.detach(), big)) < n_keep) & mask
    denom = n_keep.clamp(min=1.0)
    return (ce1 * keep2).sum() / denom, (ce2 * keep1).sum() / denom, keep1, keep2


def _bce_logits(z: torch.Tensor, target: float, w: torch.Tensor) -> torch.Tensor:
    per = F.binary_cross_entropy_with_logits(z, torch.full_like(z, target), reduction="none")
    w = w.float()
    return (per * w).sum() / w.sum().clamp(min=1.0)


def expert_bce(h, h_pos, h_neg, rows: torch.Tensor) -> torch.Tensor:
    """BCE of <h, h_pos> against 1 plus BCE of <h, h_neg> against 0, each
    averaged over ``rows``."""
    return (_bce_logits((h * h_pos).sum(-1), 1.0, rows)
            + _bce_logits((h * h_neg).sum(-1), 0.0, rows))
