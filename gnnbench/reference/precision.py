"""The precision a reference computation runs in.

``float32`` is the reference itself (TF32 off). The others are the
controls, the reference computed one step lower than a configuration
states: ``tf32`` below float32 (TF32 matrix products), ``float8`` below
bfloat16 (every product's inputs, and its output gradient in backward,
rounded to float8 e4m3 with a per-tensor scale, accumulating in float32 as
float8 products do). ``bfloat16`` rounds the products' inputs to bfloat16:
a witness at the program's own precision, never a limit.
"""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0  # largest finite float8 e4m3fn


class Precision:
    def __init__(self, kind: str = "float32"):
        if kind not in ("float32", "tf32", "bfloat16", "float8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` rounded to this precision, held in float32."""
        if self.kind == "bfloat16":
            return t.to(torch.bfloat16).float()
        if self.kind == "float8":
            amax = t.detach().abs().max().clamp(min=1e-30)
            s = FP8_MAX / amax
            return (t * s).to(torch.float8_e4m3fn).float() / s
        return t

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.kind in ("float32", "tf32"):
            return a @ b
        return _QMatmul.apply(a, b, self)

    @contextlib.contextmanager
    def matmul_mode(self):
        """TF32 on for the ``tf32`` control and off otherwise, restored after."""
        old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        on = self.kind == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class _QMatmul(torch.autograd.Function):
    """``q(a) @ q(b)``; backward rounds the output gradient too."""

    @staticmethod
    def forward(ctx, a, b, prec):
        qa, qb = prec.q(a), prec.q(b)
        ctx.save_for_backward(qa, qb)
        ctx.prec = prec
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        g = ctx.prec.q(g)
        return g @ qb.T, qa.T @ g, None
