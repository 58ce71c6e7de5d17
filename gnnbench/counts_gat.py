"""The yardstick's arithmetic for the multi-head GAT cells, counted as
``counts.py`` counts the SAGE cells: the matrix products each timed call's
algorithm needs, from its shapes alone, and the least time of the
attention kernel's calls.

A GAT layer of H heads of width C runs three products: the projection
``x W`` [F, H C] on every row it reads, the scores ``h A`` [H C, 2H] (each
head's features against att_src and att_dst) on the same rows, and the
skip ``x W_skip`` on the rows it writes. Backward counts the weight
gradient of every product and the input gradient of every product but the
first layer's projection and skip (whose input, the features, needs none);
the scores' input gradient is always needed. The attention's weighted sum
is not counted, as SAGE's mean is not.
"""

from __future__ import annotations

from .counts import FP32_OPS_PER_S, HBM_BYTES_PER_S, tree_sizes
from .gat_bind import layer_dims


def _layer_fwd(rows_read: int, rows_written: int, fin: int, heads: int, c: int,
               concat: bool):
    """A layer's (projection and skip, scores) forward operations."""
    hc = heads * c
    out = hc if concat else c
    return (2.0 * rows_read * fin * hc + 2.0 * rows_written * fin * out,
            2.0 * rows_read * hc * 2 * heads)


def gat_tree_step_flops(batch: int, fanouts, spec, nets: int = 2) -> float:
    """One co-teaching step on dense k-hop trees (every hop sampled): layer
    i reads depths 0 .. L - i and writes depths 0 .. L - 1 - i, forward and
    backward, for each net of ``spec``'s widths."""
    sizes = tree_sizes(batch, fanouts)
    layers = spec.num_layers
    total = 0.0
    for i, (fin, c, concat) in enumerate(layer_dims(spec)):
        lin, sc = _layer_fwd(sum(sizes[:layers - i + 1]), sum(sizes[:layers - i]), fin,
                             spec.heads, c, concat)
        total += lin * (2 if i == 0 else 3) + sc * 3
    return nets * total


def gat_eval_pair_flops(nodes: int, spec) -> float:
    """The paired full-graph eval: both nets' products on every node,
    forward only."""
    total = 0.0
    for fin, c, concat in layer_dims(spec):
        total += sum(_layer_fwd(nodes, nodes, fin, spec.heads, c, concat))
    return 2 * total


def gat_attn_bound_s(nodes: int, edges: int, width: int, heads: int, elem_bytes: int) -> float:
    """The least time of one attention call on the card: the rows [N, W]
    read once and the result written once, both scores [N, H] float32,
    the int32 indices and int64 row pointers read once, over the memory
    rate; or its exponentials (one an edge and head) and multiply-adds (one
    an edge and column, two operations) over the f32 rate, if larger.
    ``edges`` counts the self-loops the attention takes."""
    nbytes = 2 * nodes * width * elem_bytes + 2 * nodes * heads * 4 + edges * 4 + (nodes + 1) * 8
    ops = edges * heads + 2 * edges * width
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)
