"""Adam (Kingma and Ba, 2015) with bias correction, on a list of leaves."""

from __future__ import annotations

import torch


class Adam:
    def __init__(self, leaves: list, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8):
        self.leaves, self.lr, self.b1, self.b2, self.eps = leaves, lr, betas[0], betas[1], eps
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: list) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.leaves, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))
