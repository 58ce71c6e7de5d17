"""The program's span and counter metrics: a traced run prints every one its
cell lists, non-null, with the step's phases inside the step; over a
program without the span table the readers give nothing."""

import types

import pytest

from gnnbench import core
from gnnbench.metrics import _spans
from gnnbench.tests.common import run_cell

BENCH = core.benchmark()
OURS = [m for m in BENCH["per_layer"] if m["source"] in ("program_span", "program_counter")
        and m["name"].startswith(("span_ms.", "sample_fill"))]
PHASES = ("span_ms.sample", "span_ms.forward", "span_ms.backward", "span_ms.optimizer",
          "span_ms.rewire")


@pytest.mark.parametrize("cell", ["products_sage_co", "arxiv_sagepl_te"])
def test_traced_run_prints_the_span_metrics(cell, capsys):
    from noise_gnn_tpu_torch.utils import profiling

    profiling.reset()  # a benchmark process runs one cell; this one runs several
    rc, res = run_cell(cell, 2200000017, trace=1, capsys=capsys)
    assert rc == 0 and res["correct"], res["checks"]
    want = [m["name"] for m in OURS if cell in m["workloads"]]
    assert len(want) == (7 if cell == "arxiv_sagepl_te" else 6)
    got = {k: v["value"] for k, v in res["metrics"].items()}
    for name in want:
        assert got.get(name) is not None, name
    assert "span_ms.rewire" in got if cell == "arxiv_sagepl_te" else "span_ms.rewire" not in got
    assert sum(got[p] for p in PHASES if p in got) <= got["span_ms.step"]
    assert 0 < got["sample_fill"] <= 100
    profiling.reset()


def test_readers_give_nothing_without_the_table(monkeypatch):
    from noise_gnn_tpu_torch.utils import profiling

    m = types.SimpleNamespace(trace={})
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(profiling, "counts")
    for spec in OURS:
        assert core.reader(spec["name"]).read(m) is None, spec["name"]
    assert _spans.per_step(m, "ngt.sample") is None
