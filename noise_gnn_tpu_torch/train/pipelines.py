"""Training pipelines: ``PipelineCO``, ``PipelineS``, ``PipelineTE``,
``PipelineTES``, ``PipelineCTP``, ``PipelineH``, ``PipelineCT``,
``PipelineSG`` and ``PipelineA``.

Port of ``noise_gnn_tpu/train/pipelines.py`` for one device: the host data
(graph, splits, ``flip_label`` noise keyed by (seed, run)), the exact-leaf
table, the co-teaching loop with paired full-graph eval, the co-teaching +
consistency (CTP) loop, the co-teaching + rewired-contrast (TE) loop, the
pseudo-label co-teaching (H) loop, the contrastive warmup -> split ->
finetune (CT) pipeline, the beta x tau grid of TE runs, the
selection-analysis loop, the baseline loop, checkpoint/resume,
``do_train: false`` (load and evaluate), ``do_plot``, the reinit-retry
shell and the run summaries. The JAX package's mesh, TP,
halo and full-batch branches are not part of it: ``full_graph: true`` logs
and falls back to sampled-tree training (as the JAX package does on one
device) and ``model_parallel > 1`` raises.

Randomness: the host ``np.random.Generator`` (split batches, label noise)
is consumed exactly as in the JAX package, so both draw the same epochs'
seed batches; device randomness (init, sampling, dropout) comes from one
``torch.Generator`` on the run's device, seeded from the config. A
checkpoint carries both streams' states, so kill-and-resume replays the
uninterrupted run's batches and trees.
"""

from __future__ import annotations

import dataclasses
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
from ..noise import flip_label, noise_or_not
from ..ops.leaf_agg import fused_leaf_table, leaf_agg_eligible
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
        if int(config.get("model_parallel", 1)) > 1:
            raise ValueError(
                f"model_parallel={config['model_parallel']} needs a multi-device "
                "mesh; the port trains on one device")
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

        self.output_name = run_name(config)
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
        save_checkpoint(path, tuple(S.state_tree(s) for s in states),
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
        states = tuple(S.state_from_tree(t, opt) for t in bundle[:len(specs)])
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
        if spec.use_bn:
            return FullGraphInference(spec, self.data.csr)
        f = self.data.x.shape[-1]
        x_agg = self._fused_table(self._agg_kind(spec))[:, f:]
        return FullGraphInference(spec, self.data.csr, x_agg=x_agg)

    def _logits_fns(self, spec):
        """(logits, logits_pair) of params on the whole graph: the SpMM
        inference for the conv-stack modules, and for the others
        (gcn_head, gat) the edge-list forward over the graph's edge list, as
        the JAX package evaluates them."""
        if spec.module in STACK_MODULES:
            infer = self._make_infer(spec)
            return (lambda p: infer(p, self.data.x),
                    lambda p1, p2: infer.pair(p1, p2, self.data.x))
        eval_fn = S.make_eval_fn(spec)
        edge_index = torch.from_numpy(self.graph.edge_index).to(self.device).long()

        def logits(p):
            return eval_fn(p, self.data.x, edge_index)

        return logits, lambda p1, p2: (logits(p1), logits(p2))

    def make_eval(self, spec):
        accs = split_accuracy_fn(self.split_idx, self._y, self.graph.num_nodes)
        logits, _ = self._logits_fns(spec)

        def evaluate(params):
            return accs(logits(params))

        return evaluate

    def make_eval_pair(self, spec):
        """Fused dual-model evaluation: one [N, 2H] SpMM per layer serves
        both co-teaching nets."""
        accs = split_accuracy_fn(self.split_idx, self._y, self.graph.num_nodes)
        _, logits_pair = self._logits_fns(spec)

        def evaluate2(p1, p2):
            l1, l2 = logits_pair(p1, p2)
            return accs(l1), accs(l2)

        return evaluate2

    def spec_for(self, module: str | None = None) -> nets.NetSpec:
        c = self.config
        spec = nets.make_network({**c, "module": module or c["module"]},
                                 c["nbr_features"], c["nbr_classes"], c["nbr_nodes"])
        if c.get("full_graph"):
            self.logger.info(
                "   full_graph requested but needs a multi-device mesh - "
                "falling back to sampled-tree training")
        return spec

    def init_state(self, spec) -> S.TrainState:
        return S.init_state(self.gen, spec, self.make_optimizer, self.device)

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
        if not pure_hist:
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
                seeds, masks = self.epoch_seed_matrix(train_idx, bs)
                nb = seeds.shape[0]
                agg = S.baseline_epoch(spec, s, self.data_for(spec), seeds, masks,
                                       self.gen, noise_mat, self.fanouts,
                                       compare_loss=c["compare_loss"], exact_leaf=exact)
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
    (reference PipelineCO/PipelineS loop, src/pipeline.py:200-313)."""

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
        if c.get("do_plot"):
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
        evaluate_pair = self.make_eval_pair(spec)
        train_idx = self.split_idx["train"]
        bs = int(c["batch_size"])
        edges_per_batch = tree_edges_per_batch(bs, self.fanouts)
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
                    seeds, masks = self.epoch_seed_matrix(train_idx, bs)
                    nb = seeds.shape[0]
                    agg = S.ct_epoch(spec, s1, s2, self.data_for(spec), seeds, masks,
                                     self.gen, float(self.rate_schedule[epoch]),
                                     self.fanouts, algo=algo,
                                     co_lambda=float(c["co_lambda"]), exact_leaf=exact)
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
                              float(self.rate_schedule[epoch]), self.fanouts,
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
                               use_cr=epoch > 0, beta=1.0, spl_noise=spl_noise)

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
                             use_pseudo=epoch > 0, rewire_rate=rewire_rate)

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
        best_val, best_params = 0.0, _detached(s1.params)
        for epoch in range(warmup):
            seeds, masks = self.epoch_seed_matrix(train_idx, bs)
            nb = seeds.shape[0]
            t_train = time.perf_counter()
            agg = S.ct_epoch(spec, s1, s2, self.data_for(spec), seeds, masks, self.gen,
                             float(self.rate_schedule[epoch]), self.fanouts, exact_leaf=exact)
            rec = self._fetch_metrics(agg, nb)
            t_train = time.perf_counter() - t_train
            t_eval = time.perf_counter()
            acc1, acc2 = evaluate_pair(s1.params, s2.params)
            t_eval = time.perf_counter() - t_eval
            self.metrics.write(event="warmup", epoch=epoch,
                               val_acc_1=acc1["valid"], val_acc_2=acc2["valid"],
                               loss_1=rec["loss_1"], loss_2=rec["loss_2"],
                               epoch_train_s=t_train, epoch_eval_s=t_eval)
            self.logger.info(f"   Warmup epoch {epoch + 1}/{warmup} --- "
                             f"v1: {acc1['valid']:.3f} v2: {acc2['valid']:.3f}")
            if acc1["valid"] > best_val:
                best_val = acc1["valid"]
                best_params = _detached(s1.params)
                ckpt = f"{c['out_dir']}/models/{c['algo_type']}{self.output_name}"
                save_checkpoint(ckpt + "_m1", s1.params, {"epoch": epoch})
                save_checkpoint(ckpt + "_m2", s2.params, {"epoch": epoch})
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
        s = S.state_from_params(best_params, ft_opt)
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
        self.metrics.write(event="views", build_s=build_s, edges_s=t_edges)
        self.logger.info(f"   views built in {build_s:.1f}s (edge augmentation "
                         f"{t_edges:.1f}s on the host)")
        return views

    def _finetune(self, spec, evaluate, s, clean_ids, noisy_ids, ft_start, best_val,
                  best_test, ckpt_every, ft_ckpt):
        """The finetune's epochs, shared by the fresh path and the resume."""
        c = self.config
        lam = float(c["lambda"])
        bs2 = min(1024, max(clean_ids.size, 1))
        ids = {"clean_ids": torch.from_numpy(clean_ids).long(),
               "noisy_ids": torch.from_numpy(noisy_ids).long()}
        ft_test = []
        for epoch in range(ft_start, int(c["max_epochs"])):
            cs, cm = self.epoch_seed_matrix(clean_ids, bs2)
            ns, nm = self.epoch_seed_matrix(noisy_ids, bs2)
            nb = min(cs.shape[0], ns.shape[0])  # zip semantics
            t_train = time.perf_counter()
            agg = S.contrast_epoch(spec, s, self.data, self._ct_views, cs[:nb], cm[:nb],
                                   ns[:nb], nm[:nb], self.gen, self.fanouts, lam)
            rec = self._fetch_metrics(agg, max(nb, 1))
            t_train = time.perf_counter() - t_train
            acc = evaluate(s.params)
            best_test = max(best_test, acc["test"])
            ft_test.append(acc["test"])
            self.metrics.write(event="finetune", epoch=epoch, **rec, val_acc=acc["valid"],
                               test_acc=acc["test"], epoch_train_s=t_train, steps=nb)
            if ckpt_every and (epoch + 1) % ckpt_every == 0:
                save_checkpoint(ft_ckpt, (S.state_tree(s), ids),
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
        l1, l2 = self._logits_fns(spec)[1](p1, p2)
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
            best_params = s1.params
            if os.path.exists(best_path + ".npz"):
                best_params, _ = load_checkpoint(best_path, s1.params)
        else:
            s1, s2 = self.init_state(spec), self.init_state(spec)
            best_val = 0.0
            best_params = s1.params
        # the loop trains s1.params in place: keep a copy, not an alias
        best_params = _detached(best_params)
        for epoch in range(start_epoch, int(c["max_epochs"])):
            fr = float(self.rate_schedule[epoch])
            seeds, masks = self.epoch_seed_matrix(train_idx, bs)
            S.ct_epoch(spec, s1, s2, self.data_for(spec), seeds, masks, self.gen, fr,
                       self.fanouts, exact_leaf=exact)
            # selection-quality probes on the train set, batch by batch in order
            logits = eval_fn(s1.params, self.data.x, edge_index)
            logits2 = eval_fn(s2.params, self.data.x, edge_index)
            counts = torch.zeros(4, dtype=torch.int64, device=self.device)
            for b_seeds, b_mask in zip(*self.epoch_seed_matrix(train_idx, bs, shuffle=False)):
                o1 = logits[b_seeds]
                out = ct_loss(o1, logits2[b_seeds], self.data.yhn[b_seeds], fr,
                              self.data.clean[b_seeds], sample_mask=b_mask)
                right = o1.argmax(dim=-1) == self.data.y[b_seeds]
                counts += torch.stack([(right & out.keep_1).sum(), out.keep_1.sum(),
                                       (right & out.noisy_1).sum(), out.noisy_1.sum()])
            clean_ok, clean_n, noisy_ok, noisy_n = counts.tolist()
            acc = evaluate(s1.params)
            if acc["valid"] > best_val:
                best_val = acc["valid"]
                best_params = _detached(s1.params)
                save_checkpoint(best_path, s1.params, {"epoch": epoch, "val_acc": acc["valid"]})
            self.metrics.write(
                event="epoch_analysis", epoch=epoch,
                clean_sel_acc=clean_ok / max(clean_n, 1),
                noisy_sel_acc=noisy_ok / max(noisy_n, 1),
                val_acc=acc["valid"], test_acc=acc["test"],
            )
            if ckpt_every and (epoch + 1) % ckpt_every == 0:
                self._save_ckpt(ckpt_path, (s1, s2), 0, epoch, 0, best_val=best_val)
        # confusion matrix of the best params (reference pipeline_analysis.py:227)
        pred = eval_fn(best_params, self.data.x, edge_index).argmax(dim=-1).cpu().numpy()
        test = self.split_idx["test"]
        cm = confusion_matrix(self.graph.y[test], pred[test], self.graph.num_classes)
        np.save(f"{c['out_dir']}/metrics/confusion_{self.output_name}.npy", cm)
        self.logger.info(f"   best val {best_val:.3f}; confusion matrix saved")
        return {"best_val": best_val, "confusion": cm}


def _detached(tree):
    """A copy of a params nest that later optimizer steps do not change."""
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_detached(v) for v in tree]
    return tree.detach().clone()
