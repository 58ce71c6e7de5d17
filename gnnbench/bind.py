"""The harness's side of the program: a pipeline built as the program builds
it, with the benchmark's cache directories and the run's seed, and the
inputs the harness makes itself (the nets' weights, the forget rate).

Only the entries (``entries/*.py``) and this module import the program,
``noise_gnn_tpu_torch``; the reference never does.
"""

from __future__ import annotations

import copy
import json
import math

import numpy as np
import torch

from . import core


class Ctx:
    """One run's settings: the cell, its configuration and mix, the seed,
    the device, and changes a test makes to the configuration."""

    def __init__(self, workload: dict, cfg: dict, mix: dict, seed: int, device: str = "cuda",
                 overrides: dict | None = None):
        self.workload, self.cfg, self.mix, self.seed = workload, cfg, mix, int(seed)
        self.device = torch.device(device)
        self.overrides = dict(overrides or {})
        self.setup_record: dict = {}
        self.ref_cache: dict = {}  # the reference's graph arithmetic, kept across seeds

    def ref_graph(self, graph) -> dict:
        """The reference's graph arithmetic from the raw graph (float32
        features and the in-neighbour CSR), worked out once per process."""
        if "indptr" not in self.ref_cache:
            from gnnbench.reference import graph as rgraph

            self.ref_cache["x"] = torch.from_numpy(graph.x).to(self.device).float()
            self.ref_cache["indptr"], self.ref_cache["indices"] = rgraph.in_csr(
                graph.edge_index, graph.num_nodes, self.device)
        return self.ref_cache

    def program_config(self) -> dict:
        c = copy.deepcopy(self.cfg["config"])
        c.update(data_dir=str(core.CACHE / "data"), out_dir=str(core.CACHE / "out"),
                 device=str(self.device))
        c.update(self.overrides)
        return c


def set_cache_dirs() -> None:
    """The program's native and CUDA libraries are built into the
    benchmark's cache (a fixed path inside the checkout)."""
    from noise_gnn_tpu_torch.ops import cuda_build

    cuda_build.BUILD_DIR = core.CACHE / "kernels"


def make_pipeline(ctx: Ctx, cls_name: str):
    """The program's pipeline, built as its ``main`` builds it, and the
    setup record it writes (host seconds of each set-up phase)."""
    from noise_gnn_tpu_torch.train import pipelines

    set_cache_dirs()
    pipe = getattr(pipelines, cls_name)(ctx.program_config())
    with open(pipe.metrics.path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    ctx.setup_record = next(r for r in reversed(recs) if r.get("event") == "setup")
    return pipe


def reseed(pipe, seed: int) -> None:
    """The run's seed drives the pipeline's streams: the device generator
    (sampler, dropout), the host generator (batch order), and the label
    noise, drawn as a run keyed by the seed."""
    pipe.gen.manual_seed(core.derive_seed(seed, 1))
    pipe.rng = np.random.default_rng(core.derive_seed(seed, 2))
    pipe._flip_labels(run=int(seed))


def label_rng(cfg: dict, seed: int) -> np.random.Generator:
    """The generator the label noise of run ``seed`` is drawn from."""
    return np.random.default_rng((int(cfg["config"]["seed"]), int(seed)))


def make_params(seed: int, tag: int, dims: list[tuple[int, int]], device,
                noise_shape: tuple[int, int] | None = None) -> dict:
    """A net's weights from the run's seed, drawn on the device in one call
    (and sagePL's learned per-node noise in a second): Glorot-uniform
    ``w_neigh`` and ``w_root`` of each layer, zero biases, N(0, 1) noise."""
    gen = torch.Generator(device=device).manual_seed(core.derive_seed(seed, 3, tag))
    u = torch.rand(sum(2 * a * b for a, b in dims), generator=gen, device=device)
    convs, off = [], 0
    for fin, fout in dims:
        lim = math.sqrt(6.0 / (fin + fout))
        w = u[off:off + 2 * fin * fout].view(2, fin, fout) * (2 * lim) - lim
        off += 2 * fin * fout
        convs.append({"w_neigh": w[0].clone(), "w_root": w[1].clone(),
                      "b": torch.zeros(fout, dtype=torch.float32, device=device)})
    params = {"convs": convs}
    if noise_shape is not None:
        params["noise"] = torch.randn(noise_shape, generator=gen, device=device)
    return params


def clone_params(params: dict) -> dict:
    return {k: ([{n: t.detach().clone() for n, t in c.items()} for c in v] if k == "convs"
                else v.detach().clone()) for k, v in params.items()}


def named_leaves(params: dict, prefix: str) -> dict:
    """Leaf tensors by name: ``<prefix>.conv<i>.<key>`` and ``<prefix>.noise``."""
    out = {f"{prefix}.conv{i}.{k}": t for i, c in enumerate(params["convs"]) for k, t in c.items()}
    if "noise" in params:
        out[f"{prefix}.noise"] = params["noise"]
    return out


def forget_rate(cfg: dict, epoch: int) -> float:
    """The 'ogb' forget-rate schedule (reference src/pipeline.py:48-49):
    a ramp from 0 to noise_rate ** ct_exp over ct_tk epochs, then
    noise_rate * ct_tau; float32 as the program holds it."""
    c = cfg["config"]
    nr, tk = float(c["noise_rate"]), int(c["ct_tk"])
    if epoch < tk:
        r = np.linspace(0, nr ** float(c["ct_exp"]), tk)[epoch]
    else:
        r = nr * float(c["ct_tau"])
    return float(np.float32(r))


def layer_dims(spec) -> list[tuple[int, int]]:
    return [(spec.in_size if i == 0 else spec.hidden_size,
             spec.out_size if i == spec.num_layers - 1 else spec.hidden_size)
            for i in range(spec.num_layers)]
