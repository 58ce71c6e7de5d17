"""The multi-head GAT cells (``products_gat_co``, ``products_gat_eval``) on
the CPU at small sizes: the reference follows the program in float32,
traced runs print the cells' new metrics, the counts at small shapes by
hand, and the check fails the float8 control and the planted faults."""

import json
from types import SimpleNamespace

import pytest
import torch

from gnnbench import calibrate, core, counts_gat, run

torch.set_num_threads(1)

SMALL = {
    "products_gat_co": {"synthetic_scale": 1000, "batch_size": 64, "nbr_neighbors": [4, 3, 3]},
    "products_gat_eval": {"synthetic_scale": 1000},
}


def _run(cell, seed, capsys, trace=0, **over):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
                   "--trace", str(trace)], device="cpu", overrides={**SMALL[cell], **over})
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    return rc, (json.loads(lines[-1]) if lines else None)


def _limits(cell):
    return json.loads(core.limits_file(cell).read_text())["limits"]


@pytest.mark.parametrize("cell", ["products_gat_co", "products_gat_eval"])
def test_reference_follows_the_program_in_float32(cell, capsys):
    rc, res = _run(cell, 5, capsys, compute_dtype="float32")
    assert rc == 0 and res["correct"], res["checks"]
    for k, v in res["checks"].items():
        assert v["value"] < 1e-5, (k, v)


@pytest.mark.parametrize("cell", ["products_gat_co", "products_gat_eval"])
def test_traced_run_prints_the_cells_metrics(cell, capsys):
    from noise_gnn_tpu_torch.utils import profiling

    profiling.reset()
    rc, res = _run(cell, 2200000017, capsys, trace=1)
    assert rc == 0 and res["correct"], res["checks"]
    want = [m["name"] for m in core.benchmark()["per_layer"] if cell in m.get("workloads", [cell])]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    # the CPU trace has no device kernels: the roofline and the idle share
    # read only on the card; the step interval's p95 wants 200 intervals,
    # more than a half-second window on the CPU holds
    assert set(got) == set(want) - {"gat_attn_roofline", "step_ms_p95"}
    if cell == "products_gat_co":
        assert 0 < got["span_ms.attn"] < got["span_ms.forward"] <= got["span_ms.step"]
    profiling.reset()


def test_counts_by_hand():
    # batch 1, fanout (2,), one layer 3 -> 2 heads of 4, averaged (out 4):
    # rows read 3, written 1; projection 2*3*3*8 = 144, skip 2*1*3*4 = 24,
    # scores 2*3*8*4 = 192; backward: projection and skip 2x, scores 3x
    spec = SimpleNamespace(in_size=3, hidden_size=5, heads=2, out_size=4, num_layers=1)
    assert counts_gat.gat_tree_step_flops(1, (2,), spec, nets=1) == (144 + 24) * 2 + 192 * 3
    # eval pair: both nets on 10 nodes, same layer
    assert counts_gat.gat_eval_pair_flops(10, spec) == \
        2 * (2 * 10 * 3 * 8 + 2 * 10 * 3 * 4 + 2 * 10 * 8 * 4)
    # products pair layer 1: 2,449,029 nodes, 64,307,242 in-edges with
    # self-loops, W = 1024 bf16, 8 heads: the bytes bound it, 3.14 ms
    b = counts_gat.gat_attn_bound_s(2449029, 64307242, 1024, 8, 2)
    nbytes = 2 * 2449029 * 1024 * 2 + 2 * 2449029 * 8 * 4 + 64307242 * 4 + 2449030 * 8
    assert b == pytest.approx(nbytes / 3.35e12) and b == pytest.approx(3.14e-3, rel=1e-2)


@pytest.mark.parametrize("cell", ["products_gat_co", "products_gat_eval"])
def test_float8_control_fails(cell):
    rows = calibrate.main(["--workload", cell, "--seeds", "21", "--control-seeds", "21"],
                          device="cpu", overrides=SMALL[cell])
    ctl = [r for r in rows if r["kind"].startswith("control:")][0]["readings"]
    lim = _limits(cell)
    assert any(v > lim[k] for k, v in ctl.items() if k in lim), ctl


def test_state_left_unchanged_fails(monkeypatch, capsys):
    from noise_gnn_tpu_torch.train import steps

    monkeypatch.setattr(steps, "_step", lambda states, loss, mesh=None: None)
    rc, res = _run("products_gat_co", 22, capsys)
    assert rc == 0 and not res["correct"]
    assert res["checks"]["update"]["value"] > res["checks"]["update"]["limit"]


def test_answer_altered_fails(monkeypatch, capsys):
    from noise_gnn_tpu_torch.eval import inference

    pair = inference.FullGraphInference.pair

    def altered(self, p1, p2, x):
        l1, l2 = pair(self, p1, p2, x)
        l1 = l1.clone()
        l1[0, int(l1[0].argmin())] = l1[0].max() + 1.0
        return l1, l2

    monkeypatch.setattr(inference.FullGraphInference, "pair", altered)
    rc, res = _run("products_gat_eval", 24, capsys)
    assert rc == 0 and not res["correct"]
    assert res["checks"]["top1_gap"]["value"] > res["checks"]["top1_gap"]["limit"]


def test_parent_without_gat_ns_fails_at_setup(monkeypatch, capsys):
    """A program without the module refuses the cell at set-up, with an
    error and no result line."""
    from noise_gnn_tpu_torch.models import nets

    monkeypatch.setattr(nets, "MODULES", tuple(m for m in nets.MODULES if m != "gat_ns"))
    with pytest.raises(ValueError, match="gat_ns"):
        _run("products_gat_co", 25, capsys)
