"""The check fails what it must: the control (the reference one precision
below the configuration's) and each fault a cell can have, planted in the
timed path underneath a whole run on the CPU, come out not correct."""

import json

import pytest
import torch

from gnnbench import calibrate, core
from gnnbench.tests.common import SMALL, run_cell

TRAIN = ["products_sage_co", "arxiv_sagepl_te", "arxiv_sagepl_warm"]


def _limits(cell):
    return json.loads(core.limits_file(cell).read_text())["limits"]


def _fails(readings: dict, limits: dict) -> list[str]:
    return [k for k, v in readings.items() if k in limits and v > limits[k]]


@pytest.mark.parametrize("cell", ["products_sage_co", "products_sage_eval"])
def test_float8_control_fails(cell):
    rows = calibrate.main(["--workload", cell, "--seeds", "21", "--control-seeds", "21"],
                          device="cpu", overrides=SMALL[cell])
    ctl = [r for r in rows if r["kind"].startswith("control:")]
    assert ctl and _fails(ctl[0]["readings"], _limits(cell))


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["arxiv_sagepl_te", "arxiv_sagepl_warm"])
def test_tf32_control_fails_on_the_card(cell):
    """TF32 exists only on the card: the CPU computes float32 for it."""
    if not torch.cuda.is_available():
        pytest.skip("TF32 matrix products need a CUDA card")
    rows = calibrate.main(["--workload", cell, "--seeds", "21", "--control-seeds", "21"],
                          device="cuda", overrides=SMALL[cell])
    ctl = [r for r in rows if r["kind"].startswith("control:")]
    assert ctl and _fails(ctl[0]["readings"], _limits(cell))


@pytest.mark.parametrize("cell", TRAIN)
def test_state_left_unchanged_fails(cell, monkeypatch, capsys):
    from noise_gnn_tpu_torch.train import steps

    monkeypatch.setattr(steps, "_step", lambda states, loss, mesh=None: None)
    rc, res = run_cell(cell, 22, capsys=capsys)
    assert rc == 0 and not res["correct"]
    upd = next(res["checks"][k] for k in ("update", "update_median") if k in res["checks"])
    assert upd["value"] > upd["limit"]


@pytest.mark.parametrize("cell", TRAIN)
def test_half_batch_fails(cell, monkeypatch, capsys):
    from noise_gnn_tpu_torch.train import steps

    ct_loss = steps.ct_loss

    def half(o1, o2, y, fr, clean, mask=None):
        keep = torch.arange(y.shape[0], device=y.device) < y.shape[0] // 2
        return ct_loss(o1, o2, y, fr, clean, keep if mask is None else mask & keep)

    monkeypatch.setattr(steps, "ct_loss", half)
    rc, res = run_cell(cell, 23, capsys=capsys)
    assert rc == 0 and not res["correct"], res["checks"]


def test_answer_altered_fails(monkeypatch, capsys):
    from noise_gnn_tpu_torch.eval import inference

    pair = inference.FullGraphInference.pair

    def altered(self, p1, p2, x):
        l1, l2 = pair(self, p1, p2, x)
        l1 = l1.clone()
        l1[0, int(l1[0].argmin())] = l1[0].max() + 1.0
        return l1, l2

    monkeypatch.setattr(inference.FullGraphInference, "pair", altered)
    rc, res = run_cell("products_sage_eval", 24, capsys=capsys)
    assert rc == 0 and not res["correct"]
    assert res["checks"]["top1_gap"]["value"] > res["checks"]["top1_gap"]["limit"]
