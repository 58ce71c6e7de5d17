"""``ct_graphed`` reads the program's counter of the co-teaching steps that
replayed the step's CUDA graph, in %, and nothing where the program has
no such counter or no profiler ran."""

import types

from gnnbench import core
from gnnbench.tests.common import run_cell


def test_reader_reads_the_counter(monkeypatch):
    from noise_gnn_tpu_torch.utils import profiling

    read = core.reader("ct_graphed").read
    m = types.SimpleNamespace(trace={})
    for counts, want in (({"ct_graphed": {"hits": 240, "slots": 240}}, 100.0),
                         ({"ct_graphed": {"hits": 3, "slots": 12}}, 25.0),
                         ({"ct_graphed": {"hits": 0, "slots": 12}}, 0.0),
                         ({"sample_fill": {"hits": 1, "slots": 2}}, None)):
        monkeypatch.setattr(profiling, "counts", lambda c=counts: c)
        assert read(m) == want
    assert read(types.SimpleNamespace(trace=None)) is None
    monkeypatch.delattr(profiling, "counts")
    assert read(m) is None


def test_traced_cpu_run_reads_every_step_eager(capsys):
    from noise_gnn_tpu_torch.utils import profiling

    profiling.reset()  # a benchmark process runs one cell; this one runs several
    rc, res = run_cell("products_sage_co", 2200000017, trace=1, capsys=capsys)
    assert rc == 0 and res["correct"], res["checks"]
    assert res["metrics"]["ct_graphed"]["value"] == 0.0  # the CPU runs every step eagerly
    profiling.reset()
