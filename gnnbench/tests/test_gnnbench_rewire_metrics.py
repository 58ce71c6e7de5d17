"""The rewire's two metrics: ``rewire_fused`` reads the program's counter of
the row blocks swept by the fused route, ``rewire_sim_ms`` the extrema
kernel's span a train step; a TE run on a tree of whole tiles reads 100%
fused and an extrema span inside the rewire's, and one on a tree that is
not whole tiles reads 0% fused and no extrema span."""

import types

import pytest

from gnnbench import core
from gnnbench.tests.common import run_cell


def _tables(monkeypatch, spans, counts):
    from noise_gnn_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: spans)
    monkeypatch.setattr(profiling, "counts", lambda: counts)
    return types.SimpleNamespace(trace={})


def test_readers_read_the_counter_and_the_span(monkeypatch):
    step = {"calls": 4, "ms": 2000.0, "self_ms": 10.0}
    m = _tables(monkeypatch, {"ngt.te_step": step,
                              "ngt.rewire_sim": {"calls": 4, "ms": 640.0, "self_ms": 640.0}},
                {"rewire_fused": {"hits": 312, "slots": 312}})
    assert core.reader("rewire_sim_ms").read(m) == 160.0
    assert core.reader("rewire_fused").read(m) == 100.0
    m = _tables(monkeypatch, {"ngt.te_step": step}, {"rewire_fused": {"hits": 0, "slots": 312}})
    assert core.reader("rewire_sim_ms").read(m) is None
    assert core.reader("rewire_fused").read(m) == 0.0
    m = _tables(monkeypatch, {"ngt.te_step": step}, {})
    assert core.reader("rewire_fused").read(m) is None
    assert core.reader("rewire_fused").read(types.SimpleNamespace(trace=None)) is None


# 64 x 22 = 1,408 rows are whole 128-row tiles (the fused route);
# 48 x 22 = 1,056 rows are not (the block sweep)
@pytest.mark.parametrize("batch", [64, 48])
def test_te_run_reads_the_route(batch, capsys):
    from noise_gnn_tpu_torch.utils import profiling

    profiling.reset()
    rc, res = run_cell("arxiv_sagepl_te", 2200000019, trace=1, overrides={"batch_size": batch},
                       capsys=capsys)
    assert rc == 0 and res["correct"], res["checks"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert got["span_ms.rewire"] > 0
    if batch == 64:
        assert got["rewire_fused"] == 100
        assert 0 < got["rewire_sim_ms"] <= got["span_ms.rewire"]
    else:
        assert got["rewire_fused"] == 0.0
        assert "rewire_sim_ms" not in got
    profiling.reset()
