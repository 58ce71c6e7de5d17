"""The numbers that decide ``correct``: gaps between what the program
produced and what the reference works out, each a single float."""

from __future__ import annotations

import torch


def rel_gap(a: float, b: float) -> float:
    """|a - b| / |b|."""
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def norm_gaps(prog: dict, ref: dict) -> dict:
    """Per leaf: the gap between the program's norm and the reference's,
    over the larger of the reference leaf's norm and the median leaf's."""
    pn = {k: float(torch.linalg.vector_norm(v.float())) for k, v in prog.items()}
    rn = {k: float(torch.linalg.vector_norm(v.float())) for k, v in ref.items()}
    med = median(rn.values())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in rn}


def median(values) -> float:
    """The median leaf's reading (the upper one of an even count)."""
    v = sorted(values)
    return v[len(v) // 2]


def moved_leaves(ref_grad: dict, share: float = 1e-3) -> list[str]:
    """Leaves whose reference gradient norm is at least ``share`` of the
    median leaf's: the others move under Adam by round-off alone."""
    n = {k: float(torch.linalg.vector_norm(v)) for k, v in ref_grad.items()}
    med = median(n.values())
    return [k for k, v in n.items() if v >= share * med]


def table_gap(prog: torch.Tensor, ref: torch.Tensor, rows: int = 1 << 18) -> float:
    """max |prog - ref| / max |ref|, taken in blocks of rows."""
    num = den = 0.0
    for lo in range(0, ref.shape[0], rows):
        r = ref[lo:lo + rows].float()
        num = max(num, float((prog[lo:lo + rows].float() - r).abs().max()))
        den = max(den, float(r.abs().max()))
    return num / max(den, 1e-30)


def top1_gap(prog_logits: torch.Tensor, ref_logits: torch.Tensor) -> float:
    """The widest gap, over rows, by which the reference's logit of the
    class the program ranks first lies below the reference's best."""
    pick = prog_logits.argmax(dim=-1)
    got = ref_logits.gather(1, pick[:, None])[:, 0]
    return float((ref_logits.max(dim=-1).values - got).max())
