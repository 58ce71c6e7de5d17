"""The co-teaching step's CUDA graph (``train/step_graph.py``,
``train/steps.py::ct_graph``) on the CPU, with stand-ins where a graph
would need the card: the rule that engages it (data on a CUDA device, no
mesh, one graph per shape), the cache's lifetime (one graph for each live
pair of states, dropped when one of them dies), and the switch of the
pair's Adam to ``capturable``, which must not read as another step."""

import gc
import types

import pytest
import torch

from noise_gnn_tpu_torch.models import nets
from noise_gnn_tpu_torch.train import step_graph, steps

torch.set_num_threads(1)

SPEC = nets.NetSpec(module="sage", in_size=4, hidden_size=8, out_size=3)
FANOUTS = (3, 2)


@pytest.fixture(autouse=True)
def cache(monkeypatch):
    c = step_graph.GraphCache()
    monkeypatch.setattr(steps, "_CT_GRAPHS", c)
    return c


def _pair():
    return [steps.TrainState({}, torch.optim.Adam([torch.zeros(2, requires_grad=True)], lr=1e-3))
            for _ in range(2)]


def _on(cuda: bool):
    """Stand-in data: only where its features live is read."""
    return types.SimpleNamespace(x=types.SimpleNamespace(is_cuda=cuda))


def _graph(pair, data, batch=8, mesh=None, gen=None):
    seeds = torch.zeros(batch, dtype=torch.int64)
    return steps.ct_graph(SPEC, *pair, data, seeds, seeds > 0, gen, FANOUTS, "coteaching", 0.1,
                          True, mesh)


def test_the_rule_engages_on_cuda_without_a_mesh(cache):
    pair, data = _pair(), _on(True)
    assert _graph(pair, _on(False)) is None
    assert _graph(pair, data, mesh=object()) is None
    assert not cache.graphs
    g = _graph(pair, data)
    assert isinstance(g, step_graph.StepGraph) and g.graph is None and g.calls == 0
    assert _graph(pair, data) is g
    other = _graph(pair, data, batch=16)  # other shapes: a graph of their own, in its place
    assert other is not g and _graph(pair, data, batch=16) is other
    assert list(cache.graphs.values()) == [other]
    assert _graph(pair, _on(True)) is not other  # other data: captured anew


def test_capturable_adam_is_the_same_graph(cache):
    """The switch at the capture moves Adam's step count to the params'
    device and leaves the graph's key as it was."""
    pair, data = _pair(), _on(True)
    g = _graph(pair, data)
    p = pair[0].opt.param_groups[0]["params"][0]
    p.grad = torch.ones_like(p)
    pair[0].opt.step()
    for s in pair:
        step_graph.capturable(s.opt)
    assert all(grp["capturable"] for s in pair for grp in s.opt.param_groups)
    assert pair[0].opt.state[p]["step"].device == p.device
    assert _graph(pair, data) is g
    pair[1].opt.param_groups[0]["lr"] = 1e-4  # a setting the capture baked in
    assert _graph(pair, data) is not g


def test_one_graph_for_each_live_pair(cache):
    data = _on(True)
    a, b = _pair(), _pair()
    ga, gb = _graph(a, data), _graph(b, data)
    assert ga is not gb and len(cache.graphs) == 2
    assert ga.keep[0] is data
    del a, ga
    gc.collect()
    assert list(cache.graphs.values()) == [gb]
    b[1] = steps.TrainState({}, b[1].opt.__class__([torch.zeros(1, requires_grad=True)]))
    gc.collect()  # one state of the pair died: its graph goes
    assert not cache.graphs
