"""Training pipelines: ``PipelineCO``, ``PipelineS``, ``PipelineTE``,
``PipelineTES``, ``PipelineCTP``, ``PipelineH``, ``PipelineCT``,
``PipelineSG`` and ``PipelineA``.

Port of ``noise_gnn_tpu/train/pipelines.py``: the host data (graph,
splits, ``flip_label`` noise keyed by (seed, run)), the exact-leaf table,
the co-teaching loop with paired full-graph eval, the co-teaching +
consistency (CTP) loop, the co-teaching + rewired-contrast (TE) loop, the
pseudo-label co-teaching (H) loop, the contrastive warmup -> split ->
finetune (CT) pipeline, the beta x tau grid of TE runs, the
selection-analysis loop, the baseline loop, checkpoint/resume,
``do_train: false`` (load and evaluate), ``do_plot``, the reinit-retry
shell and the run summaries.

Several ranks (``torchrun``, ``parallel/multihost.py``): with
``data_parallel`` ``auto`` (the default) or true, every pipeline trains
data-parallel over every rank of the group (each step's seeds split over
the ranks, ``train/steps.py``) and evaluates node-sharded with the halo
exchange (``parallel/halo.py``) where its net is a conv stack; ``PipelineCO``
and ``PipelineS`` with ``full_graph: true`` train on the exact every-edge
aggregation (``parallel/fullbatch.py``). Each rank holds the graph, the
features and its own exact-leaf table. Logs, metrics, checkpoints, saved
models, plots, the noise matrix and the confusion matrix are written by
rank 0 alone; every epoch record carries the params' hash, checked equal
on every rank. ``model_parallel: M`` > 1 lays the ranks out as a (world /
M, M) grid (``parallel/mesh.py``): data parallelism over the first axis,
and tensor parallelism over the second, where every state's leaves that
the JAX package's rule picks (and their Adam moments) are split by
columns (``train/steps.py::state_from_params``); the eval, the param hash
and the checkpoints take the params gathered whole. M > 1 in one process,
or an M that does not divide the ranks, raises. In one process
``full_graph: true`` logs and falls back to sampled-tree training, as the
JAX package does on one device (and so does a mesh with M > 1).

Randomness: the host ``np.random.Generator`` (split batches, label noise)
is consumed exactly as in the JAX package, so both draw the same epochs'
seed batches; device randomness (init, sampling, dropout) comes from one
``torch.Generator`` on the run's device, seeded from the config (the same
state on every rank). A checkpoint carries both streams' states, so
kill-and-resume replays the uninterrupted run's batches and trees.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time

import numpy as np
import torch

from ..augment.edges import augment_edges_pos
from ..augment.features import shuffle_neg, shuffle_pos
from ..eval.inference import FullGraphInference, split_accuracy_fn
from ..eval.metrics import confusion_matrix
from ..graph.containers import CSRGraph
from ..graph.datasets import load_network
from ..losses.coteaching import ct_loss
from ..losses.schedules import forget_rate_schedule
from ..models import nets
from ..models.convert import gather_params
from ..noise import flip_label, noise_or_not
from ..ops.leaf_agg import fused_leaf_table, leaf_agg_eligible
from ..parallel import fullbatch as FB
from ..parallel import multihost
from ..parallel.halo import build_halo_partition, make_halo_inference, place_partition, \
    shard_features
from ..parallel.mesh import all_reduce_sum_, make_mesh
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.config import device_of, run_name, validate_config
from ..utils.logging import MetricsWriter, initialize_logger
from ..utils.plotting import plot_metrics_file
from ..utils.profiling import tree_edges_per_batch
from . import steps as S


def selection_degenerate(run_pure, clean_frac: float, tol: float = 0.005) -> bool:
    """True when the best per-epoch pure ratio over the LAST QUARTER of the
    run stays within ``tol`` of the clean fraction: small-loss selection
    never found signal (what a random subsample would score)."""
    tail = [max(p) for p in run_pure[len(run_pure) * 3 // 4:]]
    return bool(tail) and max(tail) < clean_frac + tol


def optimization_collapsed(run_loss, run_fit, clean_frac: float,
                           loss_frac_tol: float = 0.75,
                           fit_frac: float = 0.5) -> bool:
    """True when the mean training loss of the LAST 5 epochs is still above
    ``loss_frac_tol`` of the first epoch's AND the final fit to the noisy
    training targets is below ``fit_frac`` x the clean fraction (train-side
    signals only)."""
    if len(run_loss) < 10 or not run_fit:
        return False
    tail = float(np.mean(run_loss[-5:]))
    return (tail > loss_frac_tol * float(run_loss[0])
            and float(run_fit[-1]) < fit_frac * clean_frac)


class RunSummary(tuple):
    """(mean, std) of per-run BEST test accuracy, carrying final-epoch and
    last-10-epoch evidence in ``extra``."""

    def __new__(cls, mean: float, std: float, extra: dict | None = None):
        self = super().__new__(cls, (mean, std))
        self.extra = extra or {}
        return self


# modules whose eval is the full-graph SpMM inference (JAX pipelines.py:442)
STACK_MODULES = ("sage", "gcn", "sageH", "sageFC", "sagePL")


def make_optimizer(config: dict):
    """Optimizer factory (params list -> optimizer), reference
    NGNN.init_optimizer parity: 'adam' = plain Adam; 'single_adam', or
    'adam' with weight decay, = decoupled-decay AdamW (as optax.adamw)."""
    lr = float(config["learning_rate"])
    kind = config.get("optimizer", "adam")
    wd = float(config.get("weight_decay", 0.0))
    if kind == "single_adam" or (kind == "adam" and wd > 0):
        return lambda params: torch.optim.AdamW(params, lr=lr, weight_decay=wd)
    return lambda params: torch.optim.Adam(params, lr=lr)


class BasePipeline:
    """Shared setup: data, noise, schedules, logger, batching, eval."""

    schedule_variant = "ogb"
    # re-flip labels at the top of every run (reference src/pipeline.py:207-208);
    # the small-graph pipeline flips once (src/pipeline_s.py semantics)
    reflip_per_run = True

    def __init__(self, config: dict):
        validate_config(config)
        world = multihost.world_size()
        mp = int(config.get("model_parallel", 1))
        want_dp = config.get("data_parallel", "auto")
        if want_dp == "auto":
            want_dp = world > 1
        if world > 1 and not want_dp:
            raise ValueError(f"data_parallel: false at world size {world} would train "
                             f"{world} copies of one run; run one process instead")
        if mp > 1 and world == 1:
            # never a silent no-op: TP needs several ranks (JAX pipelines.py:139-146)
            raise ValueError(f"model_parallel={mp} requested but no multi-device mesh is "
                             f"available (ranks: {world}, data_parallel="
                             f"{config.get('data_parallel')!r})")
        if mp < 1 or world % mp:
            raise ValueError(f"{world} ranks not divisible by model_parallel={mp}")
        # the (data, model) grid over the ranks (parallel/mesh.py), or None
        self.mesh = make_mesh(model_parallel=mp) if want_dp and world > 1 else None
        if self.mesh is not None and "gat_ns" in (config.get("module"),
                                                  config.get("module_compare")):
            raise ValueError(f"module 'gat_ns' runs in one process, not on {world} ranks: "
                             "sharding it (data or tensor parallelism) is not supported")
        self.config = config
        self.device = device_of(config)
        self.rng = np.random.default_rng(int(config.get("seed", 0)))

        t0 = time.perf_counter()
        self.graph = load_network(config)
        self._t_load = time.perf_counter() - t0
        g = self.graph
        config["nbr_features"] = g.num_features
        config["nbr_classes"] = g.num_classes
        config["nbr_nodes"] = g.num_nodes

        self.split_idx = g.split_idx()
        if config.get("batch_size_full"):
            # one batch covering every train seed (reference src/pipeline_s.py:62-63)
            config["batch_size"] = int(self.split_idx["train"].shape[0])
        if self.mesh is not None:
            # every step's seeds split evenly over the ranks; the pad rows
            # are masked out of every loss and metric
            config["batch_size"] = int(config["batch_size"]) + (
                -int(config["batch_size"])) % self.mesh.size

        # rank 0's name on every rank (the name carries the date), so that
        # checkpoints are found where rank 0 wrote them
        self.output_name = multihost.broadcast_object(run_name(config))
        config["_output_name"] = self.output_name
        self.logger = initialize_logger(config, self.output_name)
        self.metrics = MetricsWriter(config, self.output_name)

        t0 = time.perf_counter()
        x_dtype = torch.bfloat16 if config.get("compute_dtype") == "bfloat16" else torch.float32
        # x and the CSR never change across runs: placed once, not per flip
        self._x = torch.from_numpy(g.x).to(self.device).to(x_dtype)
        self._y = torch.from_numpy(g.y).to(self.device).long()
        t1 = time.perf_counter()
        self._csr = g.csr(self.device)  # the native counting sort, then placed
        t2 = time.perf_counter()
        self._flip_labels()
        t3 = time.perf_counter()
        self.logger.info(
            f"   setup: load_network {self._t_load:.1f}s, x/y placement {t1 - t0:.1f}s, "
            f"CSR build + placement {t2 - t1:.1f}s, noise {t3 - t2:.1f}s on {self.device}"
        )
        self.metrics.write(event="setup", load_s=self._t_load, place_s=t1 - t0,
                           csr_s=t2 - t1, noise_s=t3 - t2, device=str(self.device))
        if self.mesh is not None:
            self.logger.info(f"   data-parallel over {self.mesh.size} ranks "
                             f"({multihost.process_info()['backend']}), batch_size "
                             f"{config['batch_size']}")
            if self.mesh.model_size > 1:
                self.logger.info(f"   tensor-parallel over {self.mesh.model_size} ranks "
                                 f"(mesh {dict(self.mesh.shape)})")
        if multihost.rank() == 0:
            nmat_dir = os.path.join(config.get("out_dir", "out"), "nmat")
            os.makedirs(nmat_dir, exist_ok=True)
            np.save(os.path.join(nmat_dir, f"{self.output_name}.npy"), self.noise_mat)

        self.fanouts = tuple(int(f) for f in config["nbr_neighbors"])[: config["num_layers"]]
        while len(self.fanouts) < config["num_layers"]:
            self.fanouts = self.fanouts + (self.fanouts[-1],)

        self.rate_schedule = forget_rate_schedule(
            config["max_epochs"],
            float(config["noise_rate"]),
            int(config["ct_tk"]),
            float(config["ct_tau"]),
            ct_exp=float(config.get("ct_exp", 1)),
            warmup=int(config.get("warmup", 0)) or None,
            variant=self.schedule_variant,
        )
        self.make_optimizer = make_optimizer(config)
        self._leaf_tables = {}  # exact-leaf tables by aggregation kind
        self._halo_part = self._halo_x = None  # built by _halo_ops under a mesh
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(config.get("seed", 0)))

    # --------------------------------------------------- checkpoint/resume
    # The bundle is each net's params and Adam moments; the metadata carries
    # the run position and the states of the host rng and the device
    # generator, so a resumed process replays the exact batch permutations
    # and trees (JAX package pipelines.py:299-338).

    def _ckpt_meta(self, run: int, epoch: int, attempt: int = 0) -> dict:
        # `attempt` = reinit-retry counter: a checkpoint saved mid-attempt
        # must restore it, or a crash during a retry would allow more
        # re-inits than reinit_retries
        return {"run": run, "epoch": epoch, "attempt": attempt,
                "rng_state": self.rng.bit_generator.state,
                "gen_state": bytes(self.gen.get_state().tolist()).hex()}

    def _ckpt_setup(self, tag: str):
        """(ckpt_every, ckpt_path) for a loop family; ``ckpt_path`` overrides
        the derived name, which embeds the date."""
        c = self.config
        path = c.get("ckpt_path") or f"{c['out_dir']}/models/{self.output_name}_{tag}_ckpt"
        return int(c.get("ckpt_every", 0)), path

    def _state_template(self, spec) -> dict:
        """A state tree of the spec's shapes, from a throwaway generator (the
        run's own generator is not consumed)."""
        gen = torch.Generator(device=self.device).manual_seed(0)
        return S.fresh_state_tree(nets.init_params(gen, spec, self.device))

    def _save_ckpt(self, path: str, states, run: int, epoch: int, attempt: int,
                   **meta) -> None:
        save_checkpoint(path, tuple(S.state_tree(s, self.mesh) for s in states),
                        {**self._ckpt_meta(run, epoch, attempt), **meta})

    def _try_resume(self, ckpt_path: str, specs, make_optimizer=None, extra=None):
        """Load the states (one of each spec in ``specs``) and positions if
        ``resume`` is set and the bundle exists, restoring the host rng and
        the device generator. ``extra``, a template nest, is a last member
        of the bundle, returned as loaded. Returns (states_or_None,
        start_run, start_epoch, meta), with the states followed by the extra
        member where one is given."""
        if not (self.config.get("resume") and os.path.exists(ckpt_path + ".npz")):
            return None, 0, 0, {}
        tmpl = tuple(self._state_template(spec) for spec in specs)
        bundle, meta = load_checkpoint(ckpt_path, tmpl if extra is None else (*tmpl, extra))
        if meta.get("rng_state"):
            self.rng.bit_generator.state = meta["rng_state"]
        if meta.get("gen_state"):
            self.gen.set_state(torch.tensor(list(bytes.fromhex(meta["gen_state"])),
                                            dtype=torch.uint8))
        opt = make_optimizer or self.make_optimizer
        states = tuple(S.state_from_tree(t, opt, self.mesh) for t in bundle[:len(specs)])
        run, epoch = int(meta["run"]), int(meta["epoch"]) + 1
        self.logger.info(f"   Resumed from {ckpt_path} at run {run} epoch {epoch}")
        return states + tuple(bundle[len(specs):]), run, epoch, meta

    # -------------------------------------------------------------- helpers

    def _flip_labels(self, run: int | None = None):
        """Inject label noise. With ``run`` given the realization is a pure
        function of (seed, run), so the nalgo and baseline branches of a
        multi-run A/B see the same per-run noise draws (paired comparison)."""
        g = self.graph
        rng = (
            np.random.default_rng((int(self.config.get("seed", 0)), run))
            if run is not None else self.rng
        )
        yhn, self.noise_mat = flip_label(
            g.y, g.num_classes, self.config["noise_type"],
            float(self.config["noise_rate"]), rng,
        )
        self.graph = g.replace(yhn=yhn)
        self.clean = noise_or_not(g.y, yhn)
        self.data = S.GraphData(
            x=self._x,
            y=self._y,
            yhn=torch.from_numpy(yhn).to(self.device).long(),
            clean=torch.from_numpy(self.clean).to(self.device),
            csr=self._csr,
        )

    def exact_leaf_on(self, spec) -> bool:
        return bool(self.config.get("exact_leaf")) and leaf_agg_eligible(spec, self.fanouts)

    def data_for(self, spec) -> S.GraphData:
        """GraphData for a spec, with the exact-leaf table attached when
        enabled and eligible (cached across runs and label re-flips)."""
        if not self.exact_leaf_on(spec):
            return self.data
        return dataclasses.replace(self.data,
                                   leaf_agg=self._fused_table(self._agg_kind(spec)))

    @staticmethod
    def _agg_kind(spec) -> str:
        return "sum" if spec.module == "gcn" else spec.aggr

    def _fused_table(self, kind: str) -> torch.Tensor:
        """The [N, 2F] concat([x, agg(x)], 1) table, built once per pipeline."""
        if kind not in self._leaf_tables:
            self._leaf_tables[kind] = fused_leaf_table(self.data.x, self.data.csr, aggr=kind)
            self.logger.info(f"   precomputed '{kind}' x||agg(x) table")
        return self._leaf_tables[kind]

    def epoch_seed_matrix(self, idx: np.ndarray, batch_size: int, shuffle: bool = True):
        """All of an epoch's padded seed batches as [nsteps, B] device
        tensors (seeds int64, mask bool); consumes the host rng exactly as
        the JAX package does (``shuffle=False``: in order, no draw)."""
        if shuffle:
            idx = self.rng.permutation(idx)
        n = idx.shape[0]
        nsteps = max(-(-n // batch_size), 1)
        pad = nsteps * batch_size - n
        seeds = np.concatenate([idx, np.zeros(pad, idx.dtype)])
        mask = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
        return (
            torch.from_numpy(seeds.reshape(nsteps, batch_size)).to(self.device).long(),
            torch.from_numpy(mask.reshape(nsteps, batch_size)).to(self.device),
        )

    def _make_infer(self, spec) -> FullGraphInference:
        """Full-graph inference; layer 1 reuses the exact-leaf table's
        aggregate of the raw features (built here if training did not).
        Under ``use_bn`` layer 1 aggregates ``bn1(x)``, which changes with
        the params, so no table applies and the SpMM runs at every layer
        (JAX package pipelines.py:444-463)."""
        if spec.use_bn or spec.module == "gat_ns":
            return FullGraphInference(spec, self.data.csr)
        f = self.data.x.shape[-1]
        x_agg = self._fused_table(self._agg_kind(spec))[:, f:]
        return FullGraphInference(spec, self.data.csr, x_agg=x_agg)

    def _logits_fns(self, spec):
        """(logits, logits_pair) of params on the whole graph: the SpMM
        inference for the conv-stack modules, the CSR attention inference
        for gat_ns, and for the others (gcn_head, gat) the edge-list forward
        over the graph's edge list, as the JAX package evaluates them."""
        if spec.module in STACK_MODULES or spec.module == "gat_ns":
            infer = self._make_infer(spec)
            return (lambda p: infer(p, self.data.x),
                    lambda p1, p2: infer.pair(p1, p2, self.data.x))
        eval_fn = S.make_eval_fn(spec)
        edge_index = torch.from_numpy(self.graph.edge_index).to(self.device).long()

        def logits(p):
            return eval_fn(p, self.data.x, edge_index)

        return logits, lambda p1, p2: (logits(p1), logits(p2))

    def _halo_ops(self, spec):
        """(infer, infer_pair, x_local) for node-sharded halo-exchange
        full-graph eval over the mesh (``parallel/halo.py``). The partition
        pack and this rank's feature rows are per graph, cached across runs
        and specs; the pack's seconds and exchange bytes are logged."""
        new = self._halo_part is None
        if new:
            t0 = time.perf_counter()
            host = build_halo_partition(self.graph.edge_index, self.graph.num_nodes,
                                        self.mesh.size)
            t1 = time.perf_counter()
            self._halo_part = place_partition(self.mesh, host, self.device)
            self._halo_x = shard_features(self.mesh, self.data.x, self._halo_part)
            t2 = time.perf_counter()
            self.logger.info(f"   halo partition: pack {t1 - t0:.1f}s, placement {t2 - t1:.1f}s, "
                             f"{self.mesh.size} shards of {self._halo_part.per} nodes, "
                             f"B_max {self._halo_part.b_max}")
            self.metrics.write(event="halo", pack_s=t1 - t0, place_s=t2 - t1,
                               per=self._halo_part.per, b_max=self._halo_part.b_max,
                               e_max=self._halo_part.e_max,
                               boundary_rows=self._halo_part.boundary_rows_total,
                               pair_counts=self._halo_part.pair_counts)
        _, infer, infer_pair = make_halo_inference(
            self.mesh, spec, None, self.graph.num_nodes, part=self._halo_part,
            log=self.logger.info if new else None)
        return infer, infer_pair, self._halo_x

    def _halo_accs(self):
        """Split accuracies from this rank's logit rows: each rank counts
        the correct rows of every split in its own node range, and one
        all-reduce adds the counts."""
        part, n = self._halo_part, self.graph.num_nodes
        lo, hi = self.mesh.rank * part.per, min((self.mesh.rank + 1) * part.per, n)
        parts = list(self.split_idx)
        masks = torch.zeros((len(parts), part.per), dtype=torch.bool, device=self.device)
        for i, p in enumerate(parts):
            ids = np.asarray(self.split_idx[p], np.int64)
            ids = ids[(ids >= lo) & (ids < hi)] - lo
            masks[i, torch.from_numpy(ids).to(self.device)] = True
        y = torch.full((part.per,), -1, dtype=torch.long, device=self.device)
        y[:hi - lo] = self._y[lo:hi]
        sizes = [max(int(self.split_idx[p].shape[0]), 1) for p in parts]

        def accs(logits: torch.Tensor) -> dict:
            ok = logits.argmax(dim=-1) == y
            vals = all_reduce_sum_(self.mesh, (ok[None, :] & masks).sum(dim=1)).cpu().tolist()
            return {p: float(v) / c for p, v, c in zip(parts, vals, sizes)}

        return accs

    def _halo_eval_ok(self, spec) -> bool:
        # batch-stat BN needs statistics the halo stack does not carry, GAT
        # has no SpMM and aggr='max' no sum: under the mesh these evaluate
        # replicated (every rank the whole graph), as in the JAX package; a
        # data axis of one rank (all ranks tensor-parallel) runs the SpMM
        # inference on each rank
        return (self.mesh is not None and self.mesh.size > 1
                and spec.module in STACK_MODULES and not spec.use_bn and spec.aggr != "max")

    def _fullgraph_on(self, spec) -> bool:
        """``full_graph: true`` trains on the EXACT every-edge aggregation,
        node-sharded with the halo exchange (``parallel/fullbatch.py``).
        Needs a mesh without tensor parallelism (its node shards take
        whole params) and a plain sage/gcn stack; otherwise it logs and
        falls back to sampled-tree training (JAX package
        pipelines.py:495-506)."""
        want = bool(self.config.get("full_graph"))
        ok = (self.mesh is not None and self.mesh.model_size == 1
              and spec.module in ("sage", "gcn") and not spec.use_bn and spec.aggr != "max")
        if want and not ok:
            self.logger.info(
                "   full_graph requested but needs a multi-device mesh "
                "(model_parallel=1) and a plain sage/gcn stack - falling "
                "back to sampled-tree training")
        return want and ok

    def _fullgraph_inputs(self, spec):
        """(this rank's feature rows, the train split's ids, their all-true
        mask) for a full-graph epoch; builds the halo partition."""
        _, _, x_local = self._halo_ops(spec)
        seeds = torch.from_numpy(self.split_idx["train"]).long().to(self.device)
        return x_local, seeds, torch.ones(seeds.shape[0], dtype=torch.bool, device=self.device)

    def _whole(self, params: dict) -> dict:
        """Params gathered whole over the model axis (the JAX package's
        ``_replicate_params``); as they are without tensor parallelism.
        Every rank must call it."""
        return gather_params(self.mesh, params)

    def make_eval(self, spec):
        """Split accuracies of params (this rank's, or whole), on the
        params gathered whole."""
        w = self._whole
        if self._halo_eval_ok(spec):
            infer, _, xs = self._halo_ops(spec)
            accs = self._halo_accs()
            return lambda params: accs(infer(w(params), xs))
        accs = split_accuracy_fn(self.split_idx, self._y, self.graph.num_nodes)
        logits, _ = self._logits_fns(spec)

        def evaluate(params):
            return accs(logits(w(params)))

        return evaluate

    def make_eval_pair(self, spec):
        """Fused dual-model evaluation: one [N, 2H] SpMM per layer serves
        both co-teaching nets (under a mesh, one halo exchange per layer);
        on the params gathered whole."""
        w = self._whole
        if self._halo_eval_ok(spec):
            _, infer_pair, xs = self._halo_ops(spec)
            accs = self._halo_accs()

            def evaluate2_halo(p1, p2):
                l1, l2 = infer_pair(w(p1), w(p2), xs)
                return accs(l1), accs(l2)

            return evaluate2_halo
        accs = split_accuracy_fn(self.split_idx, self._y, self.graph.num_nodes)
        _, logits_pair = self._logits_fns(spec)

        def evaluate2(p1, p2):
            l1, l2 = logits_pair(w(p1), w(p2))
            return accs(l1), accs(l2)

        return evaluate2

    def _replica_hash(self, *states) -> str:
        """A hash of the states' params gathered whole, checked equal on
        every rank of the mesh (the replicas must stay equal: the same
        steps on the same summed gradients)."""
        return _equal_on_ranks([p for s in states
                                for p in nets.parameters(self._whole(s.params))],
                               "the ranks' params differ")

    def _hash_rec(self, *states) -> dict:
        """``{"param_hash": ...}`` for an epoch record under a mesh, else {}."""
        return {"param_hash": self._replica_hash(*states)} if self.mesh is not None else {}

    def spec_for(self, module: str | None = None) -> nets.NetSpec:
        c = self.config
        return nets.make_network({**c, "module": module or c["module"]},
                                 c["nbr_features"], c["nbr_classes"], c["nbr_nodes"])

    def init_state(self, spec) -> S.TrainState:
        return S.init_state(self.gen, spec, self.make_optimizer, self.device, self.mesh)

    @staticmethod
    def _fetch_metrics(agg: dict, nb: int) -> dict:
        """One device->host transfer for the epoch's summed metrics."""
        keys = list(agg)
        vals = torch.stack([agg[k] for k in keys]).cpu().tolist()
        return {k: float(v) / nb for k, v in zip(keys, vals)}

    def _report_runs(self, label: str, best_accs: list[float],
                     test_hists: list[list[float]] | None = None,
                     reinits: list[int] | None = None) -> RunSummary:
        """Per-branch multi-run summary: best-epoch mean +- std (reference
        src/pipeline.py:267-271) plus final and last-10-epoch accuracy."""
        mean = float(np.mean(best_accs))
        std = float(np.std(best_accs, ddof=1) if len(best_accs) > 1 else 0.0)
        extra: dict = {"runs": [round(float(b), 4) for b in best_accs]}
        if test_hists:
            finals = [float(h[-1]) for h in test_hists if h]
            last10 = [float(np.mean(h[-10:])) for h in test_hists if h]
            extra.update(
                final_mean=float(np.mean(finals)),
                final_std=float(np.std(finals, ddof=1) if len(finals) > 1 else 0.0),
                last10_mean=float(np.mean(last10)),
                last10_std=float(np.std(last10, ddof=1) if len(last10) > 1 else 0.0),
                final_accs=[round(f, 4) for f in finals],
                last10_accs=[round(f, 4) for f in last10],
            )
        if reinits and any(reinits):
            extra["reinit_attempts"] = list(reinits)
        line = f"   RUN {label} mean {mean:.3f} +- {std:.3f} std"
        if test_hists:
            line += (f" | final {extra['final_mean']:.3f} +- "
                     f"{extra['final_std']:.3f} | last10 "
                     f"{extra['last10_mean']:.3f}")
        if reinits and any(reinits):
            line += f" | reinit retries per run {reinits}"
        self.logger.info(line)
        self.metrics.write(event=f"summary_{label}", mean=mean, std=std, **extra)
        return RunSummary(mean, std, extra)

    def _degen_retry(self, run: int, attempt: int, run_pure, best: float,
                     resumed_partial: bool, run_loss=None, run_fit=None) -> bool:
        """True = re-enter the run's epoch loop with fresh inits (the noise
        realization stays fixed, so paired A/Bs stay paired): the run's
        selection never found signal, or its optimization collapsed, and
        ``reinit_retries`` allows another attempt. A run resumed mid-way has
        a truncated purity tail and is never judged."""
        if resumed_partial:
            return False
        retries = int(self.config.get("reinit_retries", 0))
        clean_frac = float(np.mean(self.clean))
        degen = selection_degenerate(run_pure, clean_frac)
        opt_fail = (not degen and run_loss is not None
                    and optimization_collapsed(run_loss, run_fit or [], clean_frac))
        if not (degen or opt_fail):
            return False
        mode = (f"selection purity flat at the clean fraction ({clean_frac:.3f})"
                if degen else
                "training loss never descended (optimization collapse, selection healthy)")
        if attempt < retries:
            self.logger.warning(
                f"   RUN {run + 1}: {mode} - re-initializing and "
                f"retraining (attempt {attempt + 1}/{retries})")
            self.metrics.write(event="reinit_degenerate", run=run,
                               attempt=attempt + 1, discarded_best=best,
                               mode="selection" if degen else "optimization")
            return True
        self.logger.warning(
            f"   RUN {run + 1}: {mode} - no signal on this noise draw/init; "
            f"consider a longer epoch budget or reinit_retries > 0")
        return False

    def _save_pure(self, pure_hist: list[list[tuple]]):
        """Pure-ratio curves [runs, epochs, 2] (reference src/pipeline.py:273-275),
        runs of unequal length left-padded with NaN."""
        if not pure_hist or multihost.rank() != 0:
            return
        pure_dir = os.path.join(self.config["out_dir"], "pure")
        os.makedirs(pure_dir, exist_ok=True)
        max_e = max(len(p) for p in pure_hist)
        arr = np.full((len(pure_hist), max_e, 2), np.nan, np.float32)
        for i, p in enumerate(pure_hist):
            if p:
                arr[i, max_e - len(p):] = np.asarray(p, np.float32)
        np.save(os.path.join(pure_dir, f"{self.output_name}.npy"), arr)

    def _loop_joint(self, specs, tag: str, run_epoch) -> RunSummary:
        """The multi-run loop of nets trained under one joint loss (the JAX
        package's CTP, TE and H loops), one state of each spec in
        ``specs``: each epoch ``run_epoch(states, seeds, masks, epoch)``
        returns the summed metrics, then the first two nets are evaluated
        as a pair; records ``epoch_<tag>``, checkpoints under ``<tag>``,
        summary ``<tag>``."""
        c = self.config
        evaluate_pair = self.make_eval_pair(specs[0])
        train_idx = self.split_idx["train"]
        bs = int(c["batch_size"])
        ckpt_every, ckpt_path = self._ckpt_setup(tag)
        states, start_run, start_epoch, meta = self._try_resume(ckpt_path, specs)
        best_accs, test_hists, reinits = [], [], []
        for run in range(start_run, int(c["num_runs"])):
            if self.reflip_per_run:
                self._flip_labels(run)  # (seed, run)-keyed: pairs the A/B
            attempt = int(meta.get("attempt", 0)) if run == start_run else 0
            while True:
                resumed_partial = start_epoch > 0
                if states is None:
                    states = tuple(self.init_state(spec) for spec in specs)
                s1, s2 = states[:2]
                best = 0.0
                run_pure, run_test = [], []
                for epoch in range(start_epoch, int(c["max_epochs"])):
                    seeds, masks = self.epoch_seed_matrix(train_idx, bs)
                    nb = seeds.shape[0]
                    t_train = time.perf_counter()
                    agg = run_epoch(states, seeds, masks, epoch)
                    rec = self._fetch_metrics(agg, nb)  # device sync: train done
                    t_train = time.perf_counter() - t_train
                    t_eval = time.perf_counter()
                    acc1, acc2 = evaluate_pair(s1.params, s2.params)
                    t_eval = time.perf_counter() - t_eval
                    best = max(best, acc1["test"], acc2["test"])
                    run_test.append(max(acc1["test"], acc2["test"]))
                    run_pure.append((rec["pure_ratio_1"], rec["pure_ratio_2"]))
                    rec.update(self._hash_rec(*states))
                    self.metrics.write(
                        event=f"epoch_{tag}", run=run, epoch=epoch, **rec,
                        epoch_train_s=t_train, epoch_eval_s=t_eval,
                        val_acc_1=acc1["valid"], val_acc_2=acc2["valid"],
                        test_acc_1=acc1["test"], test_acc_2=acc2["test"],
                    )
                    if ckpt_every and (epoch + 1) % ckpt_every == 0:
                        self._save_ckpt(ckpt_path, states, run, epoch, attempt)
                    if c["epoch_logger"] and not ((epoch + 1) % 5):
                        self.logger.info(
                            f"   Train epoch {epoch + 1}/{c['max_epochs']} --- "
                            f"v1: {acc1['valid']:.3f} v2: {acc2['valid']:.3f} "
                            f"tst1: {acc1['test']:.3f} tst2: {acc2['test']:.3f}")
                self.logger.info(f"   RUN {run + 1} - best test acc: {best:.3f}")
                states, start_epoch = None, 0
                if self._degen_retry(run, attempt, run_pure, best, resumed_partial):
                    attempt += 1
                    continue
                break
            # resumed at start_epoch >= max_epochs, the epoch loop never ran
            # and `best` stays 0.0; the JAX package records it as it is
            best_accs.append(best)
            test_hists.append(run_test)
            reinits.append(attempt)
        return self._report_runs(tag, best_accs, test_hists, reinits)

    def _loop_baseline(self):
        """Plain CE / backward-correction baseline on the module_compare net
        (reference train(), src/pipeline.py:144-173)."""
        c = self.config
        spec = self.spec_for(c.get("module_compare", c["module"]))
        exact = self.exact_leaf_on(spec)
        fullgraph = self._fullgraph_on(spec)
        if fullgraph:
            fg_x, fg_seeds, fg_mask = self._fullgraph_inputs(spec)
            fg_epoch = FB.make_fullgraph_baseline_epoch(self.mesh, spec,
                                                        compare_loss=c["compare_loss"])
        evaluate = self.make_eval(spec)
        train_idx = self.split_idx["train"]
        bs = int(c["batch_size"])
        best_accs, test_hists = [], []
        for run in range(int(c["num_runs"])):
            if self.reflip_per_run:
                self._flip_labels(run)  # same (seed, run) draw as nalgo run `run`
            noise_mat = torch.as_tensor(self.noise_mat, dtype=torch.float32,
                                        device=self.device)
            s = self.init_state(spec)
            best, hist = 0.0, []
            for epoch in range(int(c["max_epochs"])):
                t_train = time.perf_counter()
                if fullgraph:
                    nb = 1
                    agg = fg_epoch(s, self._halo_part, fg_x, self.data.y, self.data.yhn,
                                   self.data.clean, fg_seeds, fg_mask, self.gen, noise_mat)
                else:
                    seeds, masks = self.epoch_seed_matrix(train_idx, bs)
                    nb = seeds.shape[0]
                    agg = S.baseline_epoch(spec, s, self.data_for(spec), seeds, masks,
                                           self.gen, noise_mat, self.fanouts,
                                           compare_loss=c["compare_loss"], exact_leaf=exact,
                                           mesh=self.mesh)
                rec_raw = self._fetch_metrics(agg, nb)  # single device sync
                t_train = time.perf_counter() - t_train
                t_eval = time.perf_counter()
                acc = evaluate(s.params)
                t_eval = time.perf_counter() - t_eval
                best = max(best, acc["test"])
                hist.append(acc["test"])
                rec = dict(
                    loss=rec_raw["loss"],
                    train_acc=rec_raw["correct"] * nb / train_idx.shape[0],
                    val_acc=acc["valid"], test_acc=acc["test"],
                    train_acc_noisy=rec_raw["agree"] * nb / train_idx.shape[0],
                    noisy_fit=rec_raw["noisyfit"] / max(rec_raw["corrupt_n"], 1e-9),
                )
                rec.update(self._hash_rec(s))
                self.metrics.write(event="epoch_baseline", run=run, epoch=epoch,
                                   **rec, epoch_train_s=t_train, epoch_eval_s=t_eval)
                if c["epoch_logger"] and not ((epoch + 1) % 10):
                    self.logger.info(
                        f"   Train epoch {epoch + 1}/{c['max_epochs']} --- "
                        f"acc t: {acc['train']:.3f} v: {acc['valid']:.3f} tst: {acc['test']:.3f}")
            self.logger.info(f"   RUN {run + 1} - best baseline test acc: {best:.3f}")
            best_accs.append(best)
            test_hists.append(hist)
        return self._report_runs("baseline", best_accs, test_hists)


class PipelineCO(BasePipeline):
    """Dual-network co-teaching + CE/backward baseline, multi-run
    (reference PipelineCO/PipelineS loop, src/pipeline.py:200-313);
    data-parallel over several ranks."""

    schedule_variant = "ogb"
    reflip_per_run = True

    def loop(self):
        c = self.config
        if not c.get("do_train", True):
            return self._load_and_eval()
        self.logger.info(f"{c['num_runs']} RUNS")
        results = {}
        if c["train_type"] in ("nalgo", "both"):
            results["nalgo"] = self._loop_ct()
        if c["train_type"] in ("baseline", "both"):
            results["baseline"] = self._loop_baseline()
        if c.get("do_plot") and multihost.rank() == 0:
            out = plot_metrics_file(self.metrics.path)
            if out:
                self.logger.info(f"   plot saved to {out}")
        return results

    def _load_and_eval(self):
        """do_train: false - load a checkpoint of two nets and evaluate each
        (JAX package pipelines.py:823-840; reference src/pipeline_s.py:305-313,
        with config-derived paths)."""
        c = self.config
        spec = self.spec_for()
        path = c.get("load_model_path") or c.get("ckpt_path") or (
            f"{c['out_dir']}/models/{self.output_name}_ct_ckpt")
        tmpl = self._state_template(spec)
        (t1, t2), meta = load_checkpoint(path, (tmpl, tmpl))
        evaluate = self.make_eval(spec)
        acc1, acc2 = evaluate(t1["params"]), evaluate(t2["params"])
        self.logger.info(f"   Load eval v1: {acc1['valid']:.3f} v2: {acc2['valid']:.3f}")
        return {"loaded": (acc1, acc2), "meta": meta}

    def _loop_ct(self):
        c = self.config
        spec = self.spec_for()
        algo = "codi" if c["algo_type"] == "codi" else "coteaching"
        exact = self.exact_leaf_on(spec)
        fullgraph = self._fullgraph_on(spec)
        if fullgraph:
            fg_x, fg_seeds, fg_mask = self._fullgraph_inputs(spec)
            fg_epoch = FB.make_fullgraph_ct_epoch(self.mesh, spec, algo=algo,
                                                  co_lambda=float(c["co_lambda"]))
        evaluate_pair = self.make_eval_pair(spec)
        train_idx = self.split_idx["train"]
        bs = int(c["batch_size"])
        edges_per_batch = (2 * spec.num_layers * self.graph.num_edges  # both nets, exact
                           if fullgraph else tree_edges_per_batch(bs, self.fanouts))
        ckpt_every, ckpt_path = self._ckpt_setup("ct")
        best_accs, test_hists, reinits, pure_hist = [], [], [], []
        states, start_run, start_epoch, meta = self._try_resume(ckpt_path, (spec, spec))
        s1, s2 = states if states is not None else (None, None)
        for run in range(start_run, int(c["num_runs"])):
            if self.reflip_per_run:
                self._flip_labels(run)  # (seed, run)-keyed: pairs the A/B
            attempt = int(meta.get("attempt", 0)) if run == start_run else 0
            while True:
                resumed_partial = start_epoch > 0
                if s1 is None:
                    s1, s2 = self.init_state(spec), self.init_state(spec)
                best1 = best2 = 0.0
                run_pure, run_test, run_loss, run_fit = [], [], [], []
                for epoch in range(start_epoch, int(c["max_epochs"])):
                    t_train = time.perf_counter()
                    fr = float(self.rate_schedule[epoch])
                    if fullgraph:
                        nb = 1
                        agg = fg_epoch(s1, s2, self._halo_part, fg_x, self.data.y,
                                       self.data.yhn, self.data.clean, fg_seeds, fg_mask,
                                       self.gen, fr)
                    else:
                        seeds, masks = self.epoch_seed_matrix(train_idx, bs)
                        nb = seeds.shape[0]
                        agg = S.ct_epoch(spec, s1, s2, self.data_for(spec), seeds, masks,
                                         self.gen, fr, self.fanouts, algo=algo,
                                         co_lambda=float(c["co_lambda"]), exact_leaf=exact,
                                         mesh=self.mesh)
                    rec_raw = self._fetch_metrics(agg, nb)  # single device sync
                    t_train = time.perf_counter() - t_train
                    t_eval = time.perf_counter()
                    acc1, acc2 = evaluate_pair(s1.params, s2.params)
                    t_eval = time.perf_counter() - t_eval
                    best1, best2 = max(best1, acc1["test"]), max(best2, acc2["test"])
                    run_test.append(max(acc1["test"], acc2["test"]))
                    rec = {k: rec_raw[k] for k in ("loss_1", "loss_2",
                                                   "pure_ratio_1", "pure_ratio_2",
                                                   "correct_1", "correct_2")}
                    for i in ("1", "2"):  # memorization probes
                        rec[f"train_acc_{i}"] = rec_raw[f"correct_{i}"] * nb / train_idx.shape[0]
                        rec[f"train_acc_noisy_{i}"] = (
                            rec_raw[f"agree_{i}"] * nb / train_idx.shape[0])
                        rec[f"noisy_fit_{i}"] = (
                            rec_raw[f"noisyfit_{i}"] / max(rec_raw["corrupt_n"], 1e-9))
                    run_pure.append((rec_raw["pure_ratio_1"], rec_raw["pure_ratio_2"]))
                    run_loss.append(min(rec_raw["loss_1"], rec_raw["loss_2"]))
                    run_fit.append(max(rec["train_acc_noisy_1"], rec["train_acc_noisy_2"]))
                    rec.update(self._hash_rec(s1, s2))
                    self.metrics.write(
                        event="epoch_ct", run=run, epoch=epoch, **rec,
                        val_acc_1=acc1["valid"], val_acc_2=acc2["valid"],
                        test_acc_1=acc1["test"], test_acc_2=acc2["test"],
                        epoch_train_s=t_train, epoch_eval_s=t_eval,
                        edges_per_s=nb * edges_per_batch / max(t_train, 1e-9),
                    )
                    if ckpt_every and (epoch + 1) % ckpt_every == 0:
                        self._save_ckpt(ckpt_path, (s1, s2), run, epoch, attempt)
                    if c["epoch_logger"] and not ((epoch + 1) % 10):
                        self.logger.info(
                            f"   Train epoch {epoch + 1}/{c['max_epochs']} --- "
                            f"acc t1: {acc1['train']:.3f} t2: {acc2['train']:.3f} "
                            f"v1: {acc1['valid']:.3f} v2: {acc2['valid']:.3f} "
                            f"tst1: {acc1['test']:.3f} tst2: {acc2['test']:.3f}")
                self.logger.info(
                    f"   RUN {run + 1} - best nalgo test acc1: {best1:.3f}   acc2: {best2:.3f}")
                s1 = s2 = None
                start_epoch = 0
                if self._degen_retry(run, attempt, run_pure, max(best1, best2),
                                     resumed_partial, run_loss=run_loss, run_fit=run_fit):
                    attempt += 1
                    continue
                break
            best_accs.append(max(best1, best2))
            test_hists.append(run_test)
            reinits.append(attempt)
            pure_hist.append(run_pure)
        self._save_pure(pure_hist)
        return self._report_runs("nalgo", best_accs, test_hists, reinits)


class PipelineS(PipelineCO):
    """Small-graph variant: 'small' forget schedule, labels flipped once
    (reference src/pipeline_s.py:52-53, loop at 187)."""

    schedule_variant = "small"
    reflip_per_run = False


class PipelineTE(BasePipeline):
    """sagePL co-teaching + top-k-rewire contrast after ct_tk epochs, both
    nets under one joint loss (JAX package pipelines.py:979-1081; reference
    PipelineTE, src/pipeline_test.py)."""

    schedule_variant = "ogb"

    def loop(self):
        """train_type dispatch (reference src/pipeline_test.py:235,290):
        'nalgo' / 'baseline' return that branch's (mean, std); 'both' returns
        a dict with both."""
        c = self.config
        results = {}
        if c["train_type"] in ("nalgo", "both"):
            results["nalgo"] = self._loop_te()
        if c["train_type"] in ("baseline", "both"):
            results["baseline"] = self._loop_baseline()
        return results if len(results) > 1 else next(iter(results.values()))

    def _loop_te(self):
        c = self.config
        kw = dict(algo="codi" if c["algo_type"] == "codi" else "coteaching",
                  co_lambda=float(c["co_lambda"]), spl_cont_beta=float(c["spl_cont_beta"]),
                  spl_rewire_rate=float(c["spl_rewire_rate"]),
                  spl_noise_rate_pos=float(c["spl_noise_rate_pos"]),
                  spl_noise_rate_neg=float(c["spl_noise_rate_neg"]))

        spec = self.spec_for()  # sagePL

        def run_epoch(states, seeds, masks, epoch):
            return S.te_epoch(spec, *states, self.data, seeds, masks, self.gen,
                              float(self.rate_schedule[epoch]), self.fanouts, mesh=self.mesh,
                              use_contrast=epoch > int(c["ct_tk"]), **kw)

        return self._loop_joint((spec, spec), "te", run_epoch)


class PipelineTES(PipelineTE):
    """Small-graph TE (reference src/pipeline_test_s.py): the 'small' forget
    schedule, labels flipped once at init."""

    schedule_variant = "small"
    reflip_per_run = False


class PipelineCTP(BasePipeline):
    """Co-teaching + uncertainty-weighted FixMatch consistency on sagePL
    (JAX package pipelines.py:1092-1179; reference PipelineCTP,
    src/pipeline_ctp.py). Epoch 0 trains without the consistency term,
    every later epoch with it."""

    schedule_variant = "ogb"

    def loop(self):
        """train_type dispatch: a single branch returns its (mean, std);
        'both' returns a dict with both (paired draws)."""
        c = self.config
        results = {}
        if c["train_type"] in ("nalgo", "both"):
            results["nalgo"] = self._loop_ctp()
        if c["train_type"] in ("baseline", "both"):
            results["baseline"] = self._loop_baseline()
        return results if len(results) > 1 else next(iter(results.values()))

    def _loop_ctp(self):
        spl_noise = float(self.config.get("spl_noise", 0.1))

        spec = self.spec_for()  # sagePL

        def run_epoch(states, seeds, masks, epoch):
            return S.ctp_epoch(spec, *states, self.data, seeds, masks, self.gen,
                               float(self.rate_schedule[epoch]), self.fanouts,
                               use_cr=epoch > 0, beta=1.0, spl_noise=spl_noise, mesh=self.mesh)

        return self._loop_joint((spec, spec), "ctp", run_epoch)


class PipelineH(BasePipeline):
    """Co-teaching + a pseudo-labeler third net on a rewired graph (JAX
    package pipelines.py:1182-1258; reference PipelineH, src/pipeline_h.py):
    the config's module (sage or sageH) twice and a ``sage`` pseudo net,
    under one joint loss; epoch 0 plain co-teaching, every later epoch with
    the pseudo net."""

    schedule_variant = "ogb"

    def loop(self):
        c = self.config
        spec, pseudo_spec = self.spec_for(), self.spec_for("sage")
        rewire_rate = float(c.get("spl_rewire_rate", 0.2))

        def run_epoch(states, seeds, masks, epoch):
            return S.h_epoch(spec, pseudo_spec, *states, self.data, seeds, masks, self.gen,
                             float(self.rate_schedule[epoch]), self.fanouts,
                             use_pseudo=epoch > 0, rewire_rate=rewire_rate, mesh=self.mesh)

        return self._loop_joint((spec, spec, pseudo_spec), "h", run_epoch)


class PipelineCT(BasePipeline):
    """Contrastive pretrain/finetune (JAX package pipelines.py:1261-1461;
    reference PipelineCT, src/pipeline_contrast.py): a co-teaching warmup
    saving the best-validation nets, a small-loss split of the train set
    into clean and noisy ids, then a finetune of net 1 by CE on the clean
    ids and a multi-view contrastive loss on the noisy ones."""

    schedule_variant = "contrast"

    def loop(self):
        c = self.config
        spec = self.spec_for()  # sageFC in config_contrast.yml
        exact = self.exact_leaf_on(spec)
        evaluate = self.make_eval(spec)
        evaluate_pair = self.make_eval_pair(spec)
        train_idx = self.split_idx["train"]
        bs = int(c["batch_size"])
        self._ct_views = self._build_views()

        # the finetune's resume bundle holds its state and the split's ids,
        # so a killed run re-enters the finetune directly (the views above
        # replay the same draws)
        ckpt_every, ft_ckpt = self._ckpt_setup("ctft")
        next_lr = float(c.get("next_lr", c["learning_rate"]))

        def ft_opt(params):
            return torch.optim.Adam(params, lr=next_lr)

        resumed, _, ft_start, ft_meta = self._try_resume(
            ft_ckpt, (spec,), ft_opt, extra={"clean_ids": None, "noisy_ids": None})
        warmup = int(c["warmup"])
        if resumed is not None:
            s, ids = resumed
            return self._finetune(spec, evaluate, s, ids["clean_ids"].numpy(),
                                  ids["noisy_ids"].numpy(), max(ft_start, warmup),
                                  float(ft_meta.get("best_val", 0.0)),
                                  float(ft_meta.get("best_test", 0.0)), ckpt_every, ft_ckpt)

        # warmup: co-teaching, the best-validation nets saved
        s1, s2 = self.init_state(spec), self.init_state(spec)
        best_val, best_params = 0.0, _detached(self._whole(s1.params))
        for epoch in range(warmup):
            seeds, masks = self.epoch_seed_matrix(train_idx, bs)
            nb = seeds.shape[0]
            t_train = time.perf_counter()
            agg = S.ct_epoch(spec, s1, s2, self.data_for(spec), seeds, masks, self.gen,
                             float(self.rate_schedule[epoch]), self.fanouts, exact_leaf=exact,
                             mesh=self.mesh)
            rec = self._fetch_metrics(agg, nb)
            t_train = time.perf_counter() - t_train
            t_eval = time.perf_counter()
            acc1, acc2 = evaluate_pair(s1.params, s2.params)
            t_eval = time.perf_counter() - t_eval
            self.metrics.write(event="warmup", epoch=epoch,
                               val_acc_1=acc1["valid"], val_acc_2=acc2["valid"],
                               loss_1=rec["loss_1"], loss_2=rec["loss_2"],
                               epoch_train_s=t_train, epoch_eval_s=t_eval,
                               **self._hash_rec(s1, s2))
            self.logger.info(f"   Warmup epoch {epoch + 1}/{warmup} --- "
                             f"v1: {acc1['valid']:.3f} v2: {acc2['valid']:.3f}")
            if acc1["valid"] > best_val:
                best_val = acc1["valid"]
                best_params = _detached(self._whole(s1.params))
                ckpt = f"{c['out_dir']}/models/{c['algo_type']}{self.output_name}"
                save_checkpoint(ckpt + "_m1", best_params, {"epoch": epoch})
                save_checkpoint(ckpt + "_m2", self._whole(s2.params), {"epoch": epoch})
                self.logger.info("   Saved  model")

        clean_ids, noisy_ids = self._split(spec, s1.params, s2.params, warmup - 1)
        cr = self.clean[clean_ids].mean() if clean_ids.size else float("nan")
        self.logger.info(f"clean ratio in clean {cr:.3f}; "
                         f"nbr clean {clean_ids.shape[0]}, noisy {noisy_ids.shape[0]}")
        self.metrics.write(event="split", clean_ratio=float(cr),
                           train_clean_frac=float(self.clean[train_idx].mean()),
                           n_clean=int(clean_ids.shape[0]), n_noisy=int(noisy_ids.shape[0]))
        # oversample noisy to clean size (reference pipeline_contrast.py:336-338)
        if noisy_ids.size and clean_ids.size > noisy_ids.size:
            extra = self.rng.integers(0, clean_ids.size, clean_ids.size - noisy_ids.size)
            noisy_ids = np.concatenate([noisy_ids, clean_ids[extra]])

        # finetune of net 1's best-validation params on a fresh Adam at next_lr
        s = S.state_from_params(best_params, ft_opt, self.mesh)
        start_acc = evaluate(s.params)
        self.logger.info(f"   finetune start (warmup best-val params): "
                         f"val {start_acc['valid']:.3f} test {start_acc['test']:.3f}")
        return self._finetune(spec, evaluate, s, clean_ids, noisy_ids, warmup, best_val,
                              start_acc["test"], ckpt_every, ft_ckpt)

    def _build_views(self) -> dict:
        """The four (x, csr) views of the finetune's contrastive loss, built
        once: two positive edge augmentations (rates prob_s and prob_l) drawn
        from the host rng, a column shuffle (positive) and a row shuffle
        (negative) of the features drawn from the device generator."""
        c, g = self.config, self.graph
        t0 = time.perf_counter()
        if c.get("augment_edge", True):
            edge_s = augment_edges_pos(g.edge_index, g.num_nodes, float(c["prob_s"]), self.rng)
            edge_l = augment_edges_pos(g.edge_index, g.num_nodes, float(c["prob_l"]), self.rng)
        else:
            edge_s = edge_l = g.edge_index
        t_edges = time.perf_counter() - t0
        x = self.data.x
        if c.get("augment_feat", True):
            feat_s = shuffle_pos(self.gen, x, float(c["prob_s"]))
            feat_l = shuffle_neg(self.gen, x)
        else:
            feat_s = feat_l = x
        views = {
            "orig": (x, self.data.csr),
            "edge_s": (x, CSRGraph.from_coo(edge_s, g.num_nodes, self.device)),
            "feat_s": (feat_s, self.data.csr),
            "large": (feat_l, CSRGraph.from_coo(edge_l, g.num_nodes, self.device)),
        }
        build_s = time.perf_counter() - t0
        rec = {}
        if self.mesh is not None:
            # each rank drew the views from its own copy of both streams
            rec["views_hash"] = _equal_on_ranks(
                [feat_s, feat_l, edge_s, edge_l], "the ranks' finetune views differ")
        self.metrics.write(event="views", build_s=build_s, edges_s=t_edges, **rec)
        self.logger.info(f"   views built in {build_s:.1f}s (edge augmentation "
                         f"{t_edges:.1f}s on the host)")
        return views

    def _finetune(self, spec, evaluate, s, clean_ids, noisy_ids, ft_start, best_val,
                  best_test, ckpt_every, ft_ckpt):
        """The finetune's epochs, shared by the fresh path and the resume."""
        c = self.config
        lam = float(c["lambda"])
        bs2 = min(1024, max(clean_ids.size, 1))
        if self.mesh is not None:  # each step's seeds split evenly over the ranks
            bs2 += (-bs2) % self.mesh.size
        ids = {"clean_ids": torch.from_numpy(clean_ids).long(),
               "noisy_ids": torch.from_numpy(noisy_ids).long()}
        ft_test = []
        for epoch in range(ft_start, int(c["max_epochs"])):
            cs, cm = self.epoch_seed_matrix(clean_ids, bs2)
            ns, nm = self.epoch_seed_matrix(noisy_ids, bs2)
            nb = min(cs.shape[0], ns.shape[0])  # zip semantics
            t_train = time.perf_counter()
            agg = S.contrast_epoch(spec, s, self.data, self._ct_views, cs[:nb], cm[:nb],
                                   ns[:nb], nm[:nb], self.gen, self.fanouts, lam, self.mesh)
            rec = {**self._fetch_metrics(agg, max(nb, 1)), **self._hash_rec(s)}
            t_train = time.perf_counter() - t_train
            acc = evaluate(s.params)
            best_test = max(best_test, acc["test"])
            ft_test.append(acc["test"])
            self.metrics.write(event="finetune", epoch=epoch, **rec, val_acc=acc["valid"],
                               test_acc=acc["test"], epoch_train_s=t_train, steps=nb)
            if ckpt_every and (epoch + 1) % ckpt_every == 0:
                save_checkpoint(ft_ckpt, (S.state_tree(s, self.mesh), ids),
                                {**self._ckpt_meta(0, epoch), "best_val": best_val,
                                 "best_test": best_test})
            self.logger.info(
                f"   Train epoch {epoch + 1}/{c['max_epochs']} --- "
                f"loss semi: {rec['loss_semi']:.3f} loss cont: {rec['loss_cont']:.3f} "
                f"val acc {acc['valid']:.3f} test acc {acc['test']:.3f}")
        final = evaluate(s.params)
        extra = {"final_mean": final["test"],
                 "last10_mean": float(np.mean(ft_test[-10:])) if ft_test else final["test"],
                 "warmup_best_val": best_val}
        self.metrics.write(event="summary_contrastive", mean=best_test, std=0.0,
                           final=final["test"], **extra)
        self.logger.info(f"   contrastive best test {best_test:.3f} (final {final['test']:.3f})")
        return {"contrastive": RunSummary(best_test, 0.0, extra), "final": final}

    def _split(self, spec, p1, p2, epoch: int):
        """Small-loss partition of the train set (reference split(),
        src/pipeline_contrast.py:110-131, which feeds SOFTMAX outputs to the
        co-teaching loss; copied) -> (clean_ids, noisy_ids). The JAX package
        takes the logits from the edge-list forward, whose scatter-add sums
        in a varying order on the card, so that a boundary node could fall
        on either side from one run to the next; here both nets' logits come
        from the pair inference, the same function through the SpMM, whose
        sums have a fixed order."""
        l1, l2 = self._logits_fns(spec)[1](self._whole(p1), self._whole(p2))
        fr = float(self.rate_schedule[epoch])
        seeds, masks = self.epoch_seed_matrix(self.split_idx["train"],
                                              int(self.config["batch_size"]), shuffle=False)
        keep, noisy = [], []
        for b_seeds, b_mask in zip(seeds, masks):
            out = ct_loss(torch.softmax(l1[b_seeds], dim=-1), torch.softmax(l2[b_seeds], dim=-1),
                          self.data.yhn[b_seeds], fr, self.data.clean[b_seeds],
                          sample_mask=b_mask)
            keep.append(out.keep_1)
            noisy.append(out.noisy_1)
        seeds = seeds.cpu().numpy()  # one sync: the masks are taken together
        return (seeds[torch.stack(keep).cpu().numpy()],
                seeds[torch.stack(noisy).cpu().numpy()])


class PipelineSG(BasePipeline):
    """Grid search over spl_cont_beta x ct_tau, one ``PipelineTES`` run per
    cell (JAX package pipelines.py:1464-1495; reference PipelineSG,
    src/pipeline_sgrid.py:176-241)."""

    schedule_variant = "small"

    def loop(self):
        c = self.config
        results = []
        for beta in c.get("grid_beta", [1.0]):
            for tau in c.get("grid_tau", [0.2]):
                # one nalgo run per cell: the cells compare hyperparameters,
                # not algorithm against baseline
                sub = dict(c, spl_cont_beta=float(beta), ct_tau=float(tau), num_runs=1,
                           do_plot=False, train_type="nalgo")
                mean, std = PipelineTES(sub).loop()
                results.append({"beta": float(beta), "tau": float(tau), "acc": mean,
                                "std": std})
                self.logger.info(f"   grid beta={beta} tau={tau} -> {mean:.3f}")
        results.sort(key=lambda r: -r["acc"])
        for r in results[:12]:
            self.logger.info(f"   top: beta={r['beta']} tau={r['tau']} acc={r['acc']:.3f}")
        self.metrics.write(event="grid_results", results=results)
        return results


class PipelineA(BasePipeline):
    """Co-teaching instrumented with selection-quality analysis: per epoch,
    net 1's accuracy on the train seeds its selection keeps and on those it
    rejects; the best-validation params saved; the confusion matrix of the
    best params on the test split (JAX package pipelines.py:1498-1587;
    reference PipelineA, src/pipeline_analysis.py). As in the JAX package it
    trains the config's module with the co-teaching epoch."""

    schedule_variant = "small"

    def loop(self):
        c = self.config
        spec = self.spec_for()
        exact = self.exact_leaf_on(spec)
        evaluate = self.make_eval(spec)
        eval_fn = S.make_eval_fn(spec)
        edge_index = torch.from_numpy(self.graph.edge_index).to(self.device).long()
        train_idx = self.split_idx["train"]
        bs = int(c["batch_size"])
        ckpt_every, ckpt_path = self._ckpt_setup("a")
        states, _, start_epoch, meta = self._try_resume(ckpt_path, (spec, spec))
        best_path = f"{c['out_dir']}/models/analysis{self.output_name}_best"
        if states is not None:
            s1, s2 = states
            best_val = float(meta.get("best_val", 0.0))
            best_params = self._whole(s1.params)
            if os.path.exists(best_path + ".npz"):
                best_params, _ = load_checkpoint(best_path, best_params)
        else:
            s1, s2 = self.init_state(spec), self.init_state(spec)
            best_val = 0.0
            best_params = self._whole(s1.params)
        # the loop trains s1.params in place: keep a copy, not an alias
        best_params = _detached(best_params)
        for epoch in range(start_epoch, int(c["max_epochs"])):
            fr = float(self.rate_schedule[epoch])
            seeds, masks = self.epoch_seed_matrix(train_idx, bs)
            S.ct_epoch(spec, s1, s2, self.data_for(spec), seeds, masks, self.gen, fr,
                       self.fanouts, exact_leaf=exact, mesh=self.mesh)
            # selection-quality probes on the train set, batch by batch in order
            w1 = self._whole(s1.params)
            logits = eval_fn(w1, self.data.x, edge_index)
            logits2 = eval_fn(self._whole(s2.params), self.data.x, edge_index)
            counts = torch.zeros(4, dtype=torch.int64, device=self.device)
            for b_seeds, b_mask in zip(*self.epoch_seed_matrix(train_idx, bs, shuffle=False)):
                o1 = logits[b_seeds]
                out = ct_loss(o1, logits2[b_seeds], self.data.yhn[b_seeds], fr,
                              self.data.clean[b_seeds], sample_mask=b_mask)
                right = o1.argmax(dim=-1) == self.data.y[b_seeds]
                counts += torch.stack([(right & out.keep_1).sum(), out.keep_1.sum(),
                                       (right & out.noisy_1).sum(), out.noisy_1.sum()])
            clean_ok, clean_n, noisy_ok, noisy_n = counts.tolist()
            acc = evaluate(w1)
            if acc["valid"] > best_val:
                best_val = acc["valid"]
                best_params = _detached(w1)
                save_checkpoint(best_path, w1, {"epoch": epoch, "val_acc": acc["valid"]})
            self.metrics.write(
                event="epoch_analysis", epoch=epoch,
                clean_sel_acc=clean_ok / max(clean_n, 1),
                noisy_sel_acc=noisy_ok / max(noisy_n, 1),
                val_acc=acc["valid"], test_acc=acc["test"], **self._hash_rec(s1, s2),
            )
            if ckpt_every and (epoch + 1) % ckpt_every == 0:
                self._save_ckpt(ckpt_path, (s1, s2), 0, epoch, 0, best_val=best_val)
        # confusion matrix of the best params (reference pipeline_analysis.py:227)
        pred = eval_fn(best_params, self.data.x, edge_index).argmax(dim=-1).cpu().numpy()
        test = self.split_idx["test"]
        cm = confusion_matrix(self.graph.y[test], pred[test], self.graph.num_classes)
        if multihost.rank() == 0:
            np.save(f"{c['out_dir']}/metrics/confusion_{self.output_name}.npy", cm)
        self.logger.info(f"   best val {best_val:.3f}; confusion matrix saved")
        return {"best_val": best_val, "confusion": cm}


def _equal_on_ranks(arrays, what: str) -> str:
    """A hash of ``arrays`` (tensors or numpy), raising ``what`` unless
    every rank's is the same."""
    h = hashlib.sha256()
    for a in arrays:
        h.update((a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)).tobytes())
    digest = h.hexdigest()[:16]
    every = multihost.all_gather_object(digest)
    if len(set(every)) != 1:
        raise RuntimeError(f"{what}: hashes {every}")
    return digest


def _detached(tree):
    """A copy of a params nest that later optimizer steps do not change."""
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_detached(v) for v in tree]
    return tree.detach().clone()
