"""The program's spans and its sampler counter (``utils/profiling.py``) on
the CPU at small sizes.

With no profiler running, ``trace`` is one shared null context that calls
nothing, and the steps record nothing; the steps' outputs, states and
generator draws are the same bit for bit whether a profiler runs or not.
Under ``torch.profiler`` the spans lie in the kineto trace, nested in time
as in the code, and the span table counts each step's phases: a TE step
with the rewired contrast runs one ``ngt.rewire`` and two ``ngt.forward``,
a plain one no rewire. The sampler's ``sample_fill`` is the mean of the
tree's child masks. Inside ``capturing`` (a CUDA graph's capture) spans
become events the graph records and counters keep their masks; each
replay under a profiler adds them, with stand-in events here, and the CPU's
eager co-teaching steps count 0 for ``ct_graphed``."""

import contextlib

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from noise_gnn_tpu_torch.graph.containers import CSRGraph
from noise_gnn_tpu_torch.models import nets
from noise_gnn_tpu_torch.ops import sampler
from noise_gnn_tpu_torch.ops.leaf_agg import fused_leaf_table
from noise_gnn_tpu_torch.train import steps
from noise_gnn_tpu_torch.utils import profiling

torch.set_num_threads(1)

N, F, C, B, STEPS = 60, 10, 4, 8, 2
FANOUTS = (3, 2)
PHASES = ("ngt.sample", "ngt.forward", "ngt.backward", "ngt.optimizer")


@pytest.fixture(scope="module")
def world():
    """A graph whose in-degrees run from 0 to 5, some under the fanouts and
    some over, so that the sampler both pads and draws."""
    rng = np.random.default_rng(0)
    src, dst = [], []
    for v in range(N):
        k = int(rng.integers(0, 6))
        src += rng.choice(np.delete(np.arange(N), v), size=k, replace=False).tolist()
        dst += [v] * k
    ei = np.stack([np.asarray(src, np.int32), np.asarray(dst, np.int32)])
    x = torch.from_numpy(rng.standard_normal((N, F)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, C, N)).long()
    yhn = torch.where(torch.from_numpy(rng.random(N) < 0.3), (y + 1) % C, y)
    csr = CSRGraph.from_coo(ei, N)
    seeds = torch.from_numpy(rng.permutation(N)[:STEPS * B].reshape(STEPS, B)).long()
    masks = torch.ones(STEPS, B, dtype=torch.bool)
    masks[-1, -3:] = False  # a padded last batch
    return dict(x=x, y=y, yhn=yhn, csr=csr, seeds=seeds, masks=masks)


@pytest.fixture(autouse=True)
def _empty_table():
    profiling.reset()
    yield
    profiling.reset()


def _states(spec):
    gen = torch.Generator().manual_seed(1)
    return [steps.init_state(gen, spec, lambda p: torch.optim.Adam(p, lr=1e-2))
            for _ in range(2)]


def _ct(world, n_steps=STEPS):
    """``n_steps`` co-teaching steps on the exact-leaf path (the products
    cell's): (per-step metrics, both states, the generator)."""
    spec = nets.NetSpec(module="sage", in_size=F, hidden_size=16, out_size=C, num_layers=3,
                        dropout=0.5)
    data = steps.GraphData(world["x"], world["y"], world["yhn"], world["y"] == world["yhn"],
                           world["csr"], fused_leaf_table(world["x"], world["csr"]))
    s1, s2 = _states(spec)
    gen = torch.Generator().manual_seed(3)
    fr = torch.tensor(0.25)
    mets = [steps.ct_step(spec, s1, s2, data, world["seeds"][k], world["masks"][k], gen, fr,
                          FANOUTS + (2,), exact_leaf=True) for k in range(n_steps)]
    return mets, (s1, s2), gen


def _te(world, contrast: bool):
    """One TE epoch of STEPS steps (sagePL), with or without the rewired
    contrast: (summed metrics, both states, the generator)."""
    spec = nets.NetSpec(module="sagePL", in_size=F, hidden_size=16, out_size=C, num_layers=2,
                        dropout=0.5, nbr_nodes=N)
    data = steps.GraphData(world["x"], world["y"], world["yhn"], world["y"] == world["yhn"],
                           world["csr"])
    s1, s2 = _states(spec)
    gen = torch.Generator().manual_seed(4)
    m = steps.te_epoch(spec, s1, s2, data, world["seeds"], world["masks"], gen, 0.25, FANOUTS,
                       use_contrast=contrast, spl_cont_beta=0.7, spl_rewire_rate=0.1,
                       spl_noise_rate_pos=0.2, spl_noise_rate_neg=0.1)
    return [torch.stack(list(m.values()))], (s1, s2), gen


def _leaves(states):
    return [p.detach().clone() for s in states for p in nets.parameters(s.params)]


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_is_one_null_context_that_calls_nothing(world, monkeypatch):
    """No profiler: every span is the same null context; a step makes no
    ``record_function`` and no CUDA event, and leaves the table, the
    counters and the event pool empty."""
    assert profiling.trace("ngt.a") is profiling.trace("ngt.b")
    assert isinstance(profiling.trace("ngt.a"), contextlib.nullcontext)

    def refuse(*a, **k):
        raise AssertionError("called with no profiler running")

    monkeypatch.setattr(profiling, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    _ct(world)
    _te(world, contrast=True)
    assert profiling.spans() == {} and profiling.counts() == {}
    assert not profiling._table.counts and not profiling._table.events


@pytest.mark.parametrize("run", [_ct, lambda w: _te(w, contrast=True)], ids=["ct", "te"])
def test_tracing_leaves_outputs_bit_equal(world, run):
    """The same seed with and without a profiler: metrics, params, Adam's
    moments and the generator's state are equal bit for bit."""
    m0, st0, g0 = run(world)
    with _cpu_profile():
        m1, st1, g1 = run(world)
    assert profiling.spans()  # the traced run recorded
    for a, b in zip(m0, m1):
        assert torch.equal(a, b)
    for a, b in zip(_leaves(st0), _leaves(st1)):
        assert torch.equal(a, b)
    for s0, s1 in zip(st0, st1):
        for p0, p1 in zip(nets.parameters(s0.params), nets.parameters(s1.params)):
            for k in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(s0.opt.state[p0][k], s1.opt.state[p1][k])
    assert torch.equal(g0.get_state(), g1.get_state())


def test_ct_spans_nest_in_the_kineto_trace(world):
    """Each ``ngt.ct_step`` holds one of each phase in time; the table
    counts one of each a step, and every self time is >= 0 and is the
    total less the children's (the host's clock on the CPU)."""
    with _cpu_profile() as prof:
        _ct(world)
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.device_type() == DeviceType.CPU and e.name().startswith("ngt.")]
    span = {}
    for e in ev:
        span.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    assert len(span["ngt.ct_step"]) == STEPS
    for name in PHASES:
        assert len(span[name]) == STEPS
        for s, e in span[name]:
            assert any(a <= s and e <= b for a, b in span["ngt.ct_step"]), name
    tab = profiling.spans()
    assert set(tab) == {"ngt.ct_step", *PHASES}
    for name, row in tab.items():
        assert row["calls"] == STEPS, name
        assert row["self_ms"] >= 0, name
    step = tab["ngt.ct_step"]
    assert step["self_ms"] == pytest.approx(
        step["ms"] - sum(tab[p]["ms"] for p in PHASES), abs=1e-9)


@pytest.mark.parametrize("contrast", [True, False])
def test_te_step_spans(world, contrast):
    """A contrast TE step records one ``ngt.rewire`` and two
    ``ngt.forward``; a plain (warm) one one forward and no rewire."""
    with _cpu_profile():
        _te(world, contrast)
    tab = profiling.spans()
    assert tab["ngt.te_step"]["calls"] == STEPS
    assert tab["ngt.forward"]["calls"] == (2 if contrast else 1) * STEPS
    for name in ("ngt.sample", "ngt.backward", "ngt.optimizer"):
        assert tab[name]["calls"] == STEPS
    assert ("ngt.rewire" in tab) == contrast
    if contrast:
        assert tab["ngt.rewire"]["calls"] == STEPS
    assert all(row["self_ms"] >= 0 for row in tab.values())


@pytest.mark.parametrize("fanouts", [(3, 2), (4, 3, 2)])
def test_sample_fill_is_the_masks_mean(world, fanouts):
    """Real child slots over allocated ones over every sampled hop, on a
    graph where some in-degrees are under the fanout and a padded batch."""
    gen = torch.Generator().manual_seed(5)
    with _cpu_profile():
        trees = [sampler.sample_khop_tree(gen, world["csr"], world["seeds"][k], fanouts,
                                          world["masks"][k]) for k in range(STEPS)]
    kids = torch.cat([m for tb in trees for m in tb.masks[1:]])
    got = profiling.counts()["sample_fill"]
    assert got == {"hits": int(kids.sum()), "slots": kids.numel()}
    assert 0 < got["hits"] < got["slots"]


def test_reset_empties_the_table(world):
    with _cpu_profile():
        _ct(world, n_steps=1)
    assert profiling.spans() and profiling.counts()
    profiling.reset()
    assert profiling.spans() == {} and profiling.counts() == {}


class _Event:
    """A stand-in CUDA event: a time (ms), read once the work it marks is
    done; ``log`` holds that state for every event of one replay."""

    def __init__(self, ms: float, log: list):
        self.ms, self.log = ms, log

    def record(self):
        self.log.append("record")

    def query(self):
        return not self.log or self.log[-1] != "record"

    def synchronize(self):
        if not self.query():
            self.log.append("wait")

    def elapsed_time(self, end):
        assert self.query() and end.query()
        return end.ms - self.ms


def test_capture_keeps_spans_and_masks(monkeypatch):
    """Inside ``capturing`` a span is two events that the graph records,
    nested as in the code, and a counter keeps its mask; nothing reaches
    the table, profiler or not."""
    log = []
    monkeypatch.setattr(torch.cuda, "Event", lambda **kw: _Event(0.0, log))
    mask = torch.tensor([True, False])
    with _cpu_profile(), profiling.capturing() as cap:
        assert profiling.counting()
        with profiling.trace("ngt.ct_step"):
            with profiling.trace("ngt.sample"):
                profiling.count("sample_fill", mask)
    assert [(n, p) for n, p, _, _ in cap.spans] == [("ngt.sample", "ngt.ct_step"),
                                                   ("ngt.ct_step", None)]
    assert cap.counts == [("sample_fill", mask)] and not profiling.counting()
    assert profiling.spans() == {} and profiling.counts() == {}


def test_replay_adds_the_captured_rows():
    """Each replay under a profiler adds the capture's spans (the
    outermost under the open span) and counters, after reading the
    previous replay's events; the graph's events never enter the pool.
    With no profiler a replay adds nothing."""
    log = []
    ev = {t: _Event(t, log) for t in (0.0, 1.0, 3.0, 5.0)}
    cap = profiling.Capture()
    cap.spans = [("ngt.sample", "ngt.ct_step", ev[1.0], ev[3.0]),
                 ("ngt.ct_step", None, ev[0.0], ev[5.0])]
    cap.counts = [("sample_fill", torch.tensor([True, False, True]))]

    class Graph:
        def replay(self):
            log.append("replay")
            ev[0.0].record()

    profiling.replay(Graph(), cap)
    assert profiling.spans() == {} and log == ["replay", "record"]
    log.clear()
    with _cpu_profile():
        with profiling.trace("outer"):
            profiling.replay(Graph(), cap)
            profiling.replay(Graph(), cap)
    assert log == ["replay", "record", "wait", "replay", "record"]
    tab = profiling.spans()
    assert tab["ngt.ct_step"] == {"calls": 2, "ms": 10.0, "self_ms": 6.0}
    assert tab["ngt.sample"] == {"calls": 2, "ms": 4.0, "self_ms": 4.0}
    assert tab["outer"]["self_ms"] == pytest.approx(tab["outer"]["ms"] - 10.0)
    assert profiling.counts() == {"sample_fill": {"hits": 4, "slots": 6}}
    assert not profiling._table.events


def test_eager_ct_steps_count_as_not_graphed(world):
    """On the CPU every co-teaching step runs eagerly: ``ct_graphed`` 0 of
    one slot a step."""
    with _cpu_profile():
        _ct(world)
    assert profiling.counts()["ct_graphed"] == {"hits": 0, "slots": STEPS}
