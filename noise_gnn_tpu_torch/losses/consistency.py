"""Consistency-regularization losses (FixMatch-style) and neighbourhood
uncertainty weighting.

Port of ``noise_gnn_tpu/losses/consistency.py`` (reference
src/utils/losses.py:182-292). The JAX module's quirks are kept as they are:
``fix_cr`` takes the CE of the noisy branch's *probability* vector treated
as logits, and ``get_uncertainty`` aggregates over edge SOURCES (each node's
out-neighbours in the sampled subgraph).
"""

from __future__ import annotations

import math

import torch

from ..ops.scatter import fast_take, segment_count, segment_sum
from ..ops.tree_agg import TreeTopo, tree_parent_gather


def _out_neighbor_mean(edge_index, h: torch.Tensor, edge_mask, epsilon: float) -> torch.Tensor:
    """Row-normalized A h over edge SOURCES: the mean over each node's
    out-neighbours (reference losses.py:199-201). A TreeTopo takes the
    scatter-free path."""
    if isinstance(edge_index, TreeTopo):
        total, deg = tree_parent_gather(h, edge_index)
        return total / (deg[:, None] + epsilon)
    n = h.shape[0]
    row, col = edge_index[0].long(), edge_index[1].long()
    if edge_mask is not None:
        row = torch.where(edge_mask, row, torch.full_like(row, n))
    total = segment_sum(fast_take(h, col), row, n + 1)[:n]
    deg = segment_count(row, n + 1)[:n]
    return total / (deg[:, None] + epsilon)


def entropy(p: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Base-2 entropy with the reference's 1e-5 guard (losses.py:182)."""
    return -(p * torch.log2(p + 1e-5)).sum(dim=axis)


def get_uncertainty(edge_index, y_pure: torch.Tensor, nbr_classes: int,
                    edge_mask=None, epsilon: float = 1e-16) -> torch.Tensor:
    """w = exp(-H(A p / deg) / log2 C), p = exp(y_pure) (y_pure is a
    log-softmax), aggregated over each node's out-neighbours (reference
    get_uncertainty_batch, losses.py:185-204)."""
    ptc = _out_neighbor_mean(edge_index, torch.exp(y_pure), edge_mask, epsilon)
    return torch.exp(-entropy(ptc) / math.log2(float(nbr_classes)))


def ce_loss(logits: torch.Tensor, targets: torch.Tensor,
            use_hard_labels: bool = True) -> torch.Tensor:
    """Per-sample CE with hard or soft targets (reference ce_loss,
    losses.py:206-213)."""
    logp = torch.log_softmax(logits, dim=-1)
    if use_hard_labels:
        return -logp.gather(1, targets.long()[:, None])[:, 0]
    return (-targets * logp).sum(dim=-1)


def fix_cr(y_pure: torch.Tensor, y_noisy: torch.Tensor, batch_size: int, name: str = "ce",
           p_cutoff: float = 0.0, use_hard_labels: bool = True, w=None,
           sample_mask=None) -> torch.Tensor:
    """FixMatch consistency between the pure and noisy branches on the seed
    rows (reference fix_cr, losses.py:215-246): hard pseudo-labels from the
    pure branch with a confidence mask max_prob >= p_cutoff, CE of the
    noisy branch's probability vector exp(y_noisy) taken as logits,
    optionally weighted by w[:batch_size]."""
    y_pure, y_noisy = y_pure[:batch_size], y_noisy[:batch_size]
    if name == "l2":
        return ((y_noisy - y_pure) ** 2).mean()
    pseudo_pure, pseudo_noisy = torch.exp(y_pure), torch.exp(y_noisy)
    max_probs, max_idx = pseudo_pure.max(dim=-1)
    mask = (max_probs >= p_cutoff).float()
    if use_hard_labels:
        masked_loss = ce_loss(pseudo_noisy, max_idx, True) * mask
    else:
        masked_loss = ce_loss(pseudo_noisy, pseudo_pure, False) * mask
    if w is not None:
        masked_loss = w[:batch_size] * masked_loss
    if sample_mask is not None:
        sm = sample_mask[:batch_size].float()
        return (masked_loss * sm).sum() / sm.sum().clamp(min=1.0)
    return masked_loss.mean()


def neighbor_align(edge_index, h: torch.Tensor, noisy_mask: torch.Tensor, temp: float = 0.1,
                   ncr_conf: float = 0.0, epsilon: float = 1e-16,
                   edge_mask=None) -> torch.Tensor:
    """Neighbourhood-consistency KL regularizer (reference
    neighbor_align_batch, losses.py:248-292, with the intended math): the
    sharpened neighbourhood mean of h, KL against h (log space) on the
    noisy-selected rows whose neighbourhood is confident."""
    mean = _out_neighbor_mean(edge_index, h, edge_mask, epsilon)
    powed = torch.pow(mean.clamp(min=0.0), 1.0 / temp)
    sharp = (powed / (powed + epsilon).sum(dim=-1, keepdim=True)).detach()
    # F.kl_div(h, sharp): sharp * (log sharp - h)
    kl_sum = (sharp * (torch.log(sharp.clamp(min=1e-30)) - h)).sum(dim=-1)
    w = (noisy_mask & (mean.amax(dim=-1) > ncr_conf)).float()
    return (kl_sum * w).sum() / w.sum().clamp(min=1.0)
