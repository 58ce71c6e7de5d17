"""The yardstick's operation and byte counts at small shapes, worked out by
hand."""

import pytest

from gnnbench import counts


def test_tree_sizes_and_edges():
    assert counts.tree_sizes(2, (3, 2)) == [2, 6, 12]
    assert counts.tree_edges_per_batch(2, (3, 2)) == 18


def test_sage_tree_step():
    # batch 2, one hop of 3, two layers 4 -> 5 -> 6, one net:
    # layer 0 on depths 0-1 (8 rows): 2 products of 2*8*4*5 = 320 each,
    #   forward 640, plus the weight gradient: 1280;
    # layer 1 on depth 0 (2 rows): 2 products of 2*2*5*6 = 120 each,
    #   forward 240, plus weight and input gradients: 720.
    assert counts.sage_tree_step_flops(2, (3,), 4, 5, 6, 2, nets=1) == 2000
    assert counts.sage_tree_step_flops(2, (3,), 4, 5, 6, 2) == 4000


def test_flat_pass_and_te_step():
    # 10 rows, 4 -> 5 -> 6: forward 2*(2*10*4*5) + 2*(2*10*5*6) = 800 + 1200
    assert counts.sage_flat_pass_flops(10, 4, 5, 6, 2, backward=False) == 2000
    assert counts.sage_flat_pass_flops(10, 4, 5, 6, 2) == 800 * 2 + 1200 * 3
    # batch 1, fanouts (1,): 2 rows; pure passes of both nets, then the
    # rewire's 2*2*2*5 and four hidden-only passes of 2*(2*2*4*5) x 2
    pure = 2 * counts.sage_flat_pass_flops(2, 4, 5, 6, 2)
    assert counts.te_step_flops(1, (1,), 4, 5, 6, 2, contrast=False) == pure
    assert counts.te_step_flops(1, (1,), 4, 5, 6, 2, contrast=True) == pure + 40 + 4 * 320


def test_eval_pair():
    assert counts.eval_pair_flops(10, 4, 5, 6, 2) == 2 * 2000


def test_spmm_bound():
    # 1000 nodes, 5000 edges, width 8, bf16: 2*1000*8*2 + 5000*4 + 1001*8 bytes
    nbytes = 32000 + 20000 + 8008
    assert counts.spmm_bound_s(1000, 5000, 8, 2) == pytest.approx(nbytes / 3.35e12)
    # at the products eval's shape the bytes bound it: 1.577 ms
    assert counts.spmm_bound_s(2449029, 61858213, 512, 2) == pytest.approx(1.577e-3, rel=1e-3)
