"""Co-teaching family losses, on device with static shapes.

Port of ``noise_gnn_tpu/losses/coteaching.py`` (reference
src/utils/losses.py:10-180). Small-loss selection is a rank mask: keep sample
i iff rank(loss_i) < n_keep, n_keep = floor((1 - forget_rate) * n_valid),
computed as a tensor so no step syncs with the host. Ranks come from a
STABLE argsort, as ``jnp.argsort`` is stable: tied losses, and the padded
rows that all carry the same ``big`` loss, select the same samples in both
packages. Selected-set CE is ``sum(ce * mask) / n_keep``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample CE (F.cross_entropy(reduction='none') semantics)."""
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels.long()[:, None])[:, 0]


def _rank_of(values: torch.Tensor) -> torch.Tensor:
    """rank[i] = position of i in the stable ascending sort of ``values``."""
    order = torch.argsort(values, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=order.device)
    return rank


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def small_loss_selection(per_sample_loss: torch.Tensor, forget_rate):
    """(keep_mask [B] bool, n_keep f32, rank [B]) of the (1-forget_rate)
    fraction smallest losses; n_keep truncates like the reference's int()."""
    b = per_sample_loss.shape[0]
    fr = _f32(forget_rate, per_sample_loss.device)
    n_keep = torch.floor((1.0 - fr) * b + 1e-4)
    rank = _rank_of(per_sample_loss)
    return rank < n_keep, n_keep, rank


class CTLossOut(NamedTuple):
    loss_1: torch.Tensor
    loss_2: torch.Tensor
    pure_ratio_1: torch.Tensor
    pure_ratio_2: torch.Tensor
    keep_1: torch.Tensor  # net1's small-loss selection
    keep_2: torch.Tensor
    noisy_1: torch.Tensor  # rejected by net1
    noisy_2: torch.Tensor


def ct_loss(logits_1, logits_2, y_noise, forget_rate, clean_mask,
            sample_mask=None) -> CTLossOut:
    """Co-teaching with small-loss exchange (reference CTLoss,
    losses.py:19-49). ``clean_mask`` (True = clean) only feeds the pure-ratio
    diagnostics; ``sample_mask`` marks valid rows of a padded batch."""
    ce1 = cross_entropy(logits_1, y_noise)
    ce2 = cross_entropy(logits_2, y_noise)
    return _exchange(ce1, ce2, logits_1, logits_2, y_noise, y_noise, forget_rate,
                     clean_mask, sample_mask)


def _exchange(ce1, ce2, logits_1, logits_2, y_noise_1, y_noise_2, forget_rate, clean_mask,
              sample_mask):
    dev = ce1.device
    ce1, ce2 = ce1.detach(), ce2.detach()  # selection is not differentiated
    big = torch.finfo(ce1.dtype).max / 2
    if sample_mask is not None:
        # padded rows get `big` loss so they sort last and are never kept
        n_valid = sample_mask.sum()
        ce1 = torch.where(sample_mask, ce1, big)
        ce2 = torch.where(sample_mask, ce2, big)
    else:
        n_valid = _f32(ce1.shape[0], dev)
    n_keep = torch.floor((1.0 - _f32(forget_rate, dev)) * n_valid + 1e-4)
    keep1 = _rank_of(ce1) < n_keep
    keep2 = _rank_of(ce2) < n_keep
    if sample_mask is not None:
        keep1 = keep1 & sample_mask
        keep2 = keep2 & sample_mask

    denom = n_keep.clamp(min=1.0)
    clean = clean_mask.float()
    pure_1 = (clean * keep1).sum() / denom
    pure_2 = (clean * keep2).sum() / denom

    # exchange: net1 trains on net2's selection and vice-versa
    loss_1 = (cross_entropy(logits_1, y_noise_1) * keep2).sum() / denom
    loss_2 = (cross_entropy(logits_2, y_noise_2) * keep1).sum() / denom

    noisy1, noisy2 = ~keep1, ~keep2
    if sample_mask is not None:
        noisy1 = noisy1 & sample_mask
        noisy2 = noisy2 & sample_mask
    return CTLossOut(loss_1, loss_2, pure_1, pure_2, keep1, keep2, noisy1, noisy2)


def _js_per_sample(logits_1, logits_2) -> torch.Tensor:
    """Per-sample Jensen-Shannon terms in F.kl_div's convention
    (reference losses.py:95-105)."""
    p1 = F.softmax(logits_1, dim=-1)
    p2 = F.softmax(logits_2, dim=-1)
    m = (p1 + p2) / 2.0
    logm = torch.log(m.clamp(min=1e-30))
    kl1 = m * (logm - F.log_softmax(logits_1, dim=-1))
    kl2 = m * (logm - F.log_softmax(logits_2, dim=-1))
    return ((kl1 + kl2) / 2.0).sum(dim=-1)


def codi_loss(logits_1, logits_2, y_noise, forget_rate, clean_mask,
              co_lambda: float = 0.1, sample_mask=None) -> CTLossOut:
    """CoDis: selection on CE - co_lambda * JS (detached), then the same
    small-loss exchange on plain CE (reference CoDiLoss, losses.py:106-137)."""
    js = _js_per_sample(logits_1, logits_2).detach()
    ce1 = cross_entropy(logits_1, y_noise) - co_lambda * js
    ce2 = cross_entropy(logits_2, y_noise) - co_lambda * js
    return _exchange(ce1, ce2, logits_1, logits_2, y_noise, y_noise, forget_rate,
                     clean_mask, sample_mask)


def ct_loss2(logits_1, logits_2, y_noise_1, y_noise_2, forget_rate, clean_mask,
             sample_mask=None) -> CTLossOut:
    """CTLoss2: co-teaching where each net has its own noisy-label view
    (reference losses.py:141-180): net i ranks its CE on ``y_noise_i``, and
    the exchange trains net 1 on net 2's selection of its own view and
    vice-versa. Unlike :func:`ct_loss`, the rejected masks are not limited
    to ``sample_mask`` (as the JAX package's are not)."""
    out = _exchange(cross_entropy(logits_1, y_noise_1), cross_entropy(logits_2, y_noise_2),
                    logits_1, logits_2, y_noise_1, y_noise_2, forget_rate, clean_mask,
                    sample_mask)
    return out._replace(noisy_1=~out.keep_1, noisy_2=~out.keep_2)


def backward_correction(logits, labels, noise_mat, sample_mask=None) -> torch.Tensor:
    """Backward loss correction with the injected noise matrix C:
    -mean(onehot @ C^-1 * log(clamp(softmax(out)))) over all B*C elements
    (reference losses.py:51-70). ``inv_ex`` skips the singularity check,
    which would sync with the host every step."""
    c_inv = torch.linalg.inv_ex(noise_mat.float())[0]
    onehot = F.one_hot(labels.long(), noise_mat.shape[0]).float()
    probs = F.softmax(logits.float(), dim=-1).clamp(1e-5, 1.0 - 1e-5)
    elems = (onehot @ c_inv) * torch.log(probs)
    if sample_mask is None:
        return -elems.mean()
    w = sample_mask.float()[:, None]
    return -(elems * w).sum() / (w.sum() * elems.shape[1]).clamp(min=1.0)
