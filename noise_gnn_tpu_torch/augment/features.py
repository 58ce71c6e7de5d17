"""Feature-view augmentations (reference: src/utils/augmentation.py:88-115).

Port of ``noise_gnn_tpu/augment/features.py``, with random numbers from an
explicit ``torch.Generator``. ``shuffle_pos``: in each row independently,
pick ``int(prob * F)`` random columns and permute the picked elements
within the row (the positive view). ``shuffle_neg``: permute whole rows
(the negative view).
"""

from __future__ import annotations

import torch


def shuffle_pos(gen: torch.Generator, x: torch.Tensor, prob: float = 0.1) -> torch.Tensor:
    n, f = x.shape
    m = int(f * prob)
    if m <= 1:
        return x
    # per row, m distinct columns: the first m of a random order
    sel = torch.argsort(torch.rand((n, f), generator=gen, device=x.device), dim=1)[:, :m]
    perm = torch.argsort(torch.rand((n, m), generator=gen, device=x.device), dim=1)
    vals = torch.gather(x, 1, torch.gather(sel, 1, perm))
    return x.scatter(1, sel, vals)


def shuffle_neg(gen: torch.Generator, x: torch.Tensor) -> torch.Tensor:
    return x[torch.randperm(x.shape[0], generator=gen, device=x.device)]
