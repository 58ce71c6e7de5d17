"""The yardstick's arithmetic: published peaks of the card, and the
operations and bytes that each timed call's algorithm needs, from its
shapes alone.

Matrix products count 2 * m * k * n operations. A backward pass counts the
weight gradient of every layer and the input gradient of every layer but
the first (whose input, the features, needs none). Nothing counts what an
implementation does beyond the algorithm (recomputation, padding rows).
"""

from __future__ import annotations

# NVIDIA H100 SXM, data sheet, dense rates at the 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def tree_sizes(batch: int, fanouts) -> list[int]:
    """Rows of each depth of a dense sampled tree: B, B f1, B f1 f2, ..."""
    sizes = [int(batch)]
    for f in fanouts:
        sizes.append(sizes[-1] * int(f))
    return sizes


def tree_edges_per_batch(batch: int, fanouts) -> int:
    """Sampled (parent, child) pairs of one tree."""
    return sum(tree_sizes(batch, fanouts)[1:])


def layer_dims(in_size: int, hidden: int, out_size: int, layers: int) -> list[tuple[int, int]]:
    return [(in_size if i == 0 else hidden, out_size if i == layers - 1 else hidden)
            for i in range(layers)]


def sage_tree_step_flops(batch: int, fanouts, in_size: int, hidden: int, out_size: int,
                         layers: int, nets: int = 2) -> float:
    """One co-teaching step on dense k-hop trees: each SAGE layer i runs
    two products (neighbour mean and root) on the rows of depths
    0 .. L-1-i, forward and backward, for each net."""
    sizes = tree_sizes(batch, fanouts)
    total = 0.0
    for i, (fin, fout) in enumerate(layer_dims(in_size, hidden, out_size, layers)):
        rows = sum(sizes[:layers - i])
        fwd = 2 * (2.0 * rows * fin * fout)
        total += fwd * (2 if i == 0 else 3)  # forward + weight grad (+ input grad)
    return nets * total


def sage_flat_pass_flops(rows: int, in_size: int, hidden: int, out_size: int, layers: int,
                         backward: bool = True) -> float:
    """One SAGE stack pass over a flat subgraph of ``rows`` rows (every
    layer on every row, as the flat forward runs it)."""
    total = 0.0
    for i, (fin, fout) in enumerate(layer_dims(in_size, hidden, out_size, layers)):
        fwd = 2 * (2.0 * rows * fin * fout)
        total += fwd * ((2 if i == 0 else 3) if backward else 1)
    return total


def rewire_flops(rows: int, hidden: int) -> float:
    """The rewire's cosine similarities of every flat row with every other:
    one [n, H] x [H, n] product (both sweeps share it)."""
    return 2.0 * rows * rows * hidden


def te_step_flops(batch: int, fanouts, in_size: int, hidden: int, out_size: int,
                  layers: int, contrast: bool) -> float:
    """One TE step: both nets' pure passes over the flat subgraph; with the
    contrast, the rewire's product and four more passes (each net's pure
    pass over the positive graph and noisy pass over the negative one) of
    which only the hidden layers are read."""
    rows = sum(tree_sizes(batch, fanouts))
    total = 2 * sage_flat_pass_flops(rows, in_size, hidden, out_size, layers)
    if contrast:
        total += rewire_flops(rows, hidden)
        total += 4 * sage_flat_pass_flops(rows, in_size, hidden, hidden, layers - 1)
    return total


def eval_pair_flops(nodes: int, in_size: int, hidden: int, out_size: int, layers: int) -> float:
    """The paired full-graph eval: both nets' two products a layer on every
    node, forward only."""
    return 2 * sage_flat_pass_flops(nodes, in_size, hidden, out_size, layers, backward=False)


def spmm_bound_s(nodes: int, edges: int, width: int, elem_bytes: int) -> float:
    """The least time of one CSR SpMM on the card: the input read once, the
    output written once, the int32 indices and the int64 row pointers read
    once, over the memory rate; or its adds over the f32 rate, if larger."""
    nbytes = 2 * nodes * width * elem_bytes + edges * 4 + (nodes + 1) * 8
    ops = edges * width + nodes * width
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)
