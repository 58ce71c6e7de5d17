"""The harness's side of the program for the multi-head GAT cells: the nets'
weights made from the run's seed, in the program's layout (``{"convs":
[{"w", "att_src", "att_dst", "b", "skip_w", "skip_b"}, ...]}``, weights
``[in, out]``), for the program and the reference alike."""

from __future__ import annotations

import math

import torch

from . import core


def layer_dims(spec) -> list[tuple[int, int, bool]]:
    """(input width, width a head, heads concatenated) of each layer:
    hidden layers ``heads x hidden_size`` wide, the last averaging its
    heads of ``out_size``."""
    wide = spec.heads * spec.hidden_size
    return [(spec.in_size if i == 0 else wide,
             spec.out_size if i == spec.num_layers - 1 else spec.hidden_size,
             i != spec.num_layers - 1) for i in range(spec.num_layers)]


def make_params(seed: int, tag: int, spec, device) -> dict:
    """A net's weights from the run's seed, drawn on the device in one call:
    Glorot-uniform ``w`` [F, H C], ``att_src`` and ``att_dst`` [H, C] and
    ``skip_w`` [F, out] of each layer, in that order; zero biases."""
    heads = spec.heads
    shapes = []
    for fin, c, concat in layer_dims(spec):
        out = heads * c if concat else c
        shapes.append([(fin, heads * c), (heads, c), (heads, c), (fin, out)])
    gen = torch.Generator(device=device).manual_seed(core.derive_seed(seed, 3, tag))
    u = torch.rand(sum(a * b for layer in shapes for a, b in layer), generator=gen,
                   device=device)
    convs, off = [], 0
    for layer in shapes:
        leaves = []
        for a, b in layer:
            lim = math.sqrt(6.0 / (a + b))
            leaves.append(u[off:off + a * b].view(a, b) * (2 * lim) - lim)
            off += a * b
        w, att_src, att_dst, skip_w = leaves
        out = skip_w.shape[1]
        convs.append({"w": w, "att_src": att_src, "att_dst": att_dst,
                      "b": torch.zeros(out, dtype=torch.float32, device=device),
                      "skip_w": skip_w,
                      "skip_b": torch.zeros(out, dtype=torch.float32, device=device)})
    return {"convs": convs}
