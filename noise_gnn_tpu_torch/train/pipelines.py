"""Training pipelines of the main path: ``PipelineCO`` and ``PipelineS``.

Port of ``noise_gnn_tpu/train/pipelines.py`` for one device: the host data
(graph, splits, ``flip_label`` noise keyed by (seed, run)), the exact-leaf
table, the co-teaching loop with paired full-graph eval, the baseline loop,
the reinit-retry shell and the run summaries. The JAX package's mesh, TP,
halo and full-batch branches are not part of it: ``full_graph: true`` logs
and falls back to sampled-tree training (as the JAX package does on one
device) and ``model_parallel > 1`` raises. Checkpoint/resume, ``do_train:
false`` and ``do_plot`` raise "not yet ported".

Randomness: the host ``np.random.Generator`` (split batches, label noise)
is consumed exactly as in the JAX package, so both draw the same epochs'
seed batches; device randomness (init, sampling, dropout) comes from one
``torch.Generator`` on the run's device, seeded from the config.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from ..eval.inference import FullGraphInference, split_accuracy_fn
from ..graph.datasets import load_network
from ..losses.schedules import forget_rate_schedule
from ..models import nets
from ..noise import flip_label, noise_or_not
from ..ops.leaf_agg import fused_leaf_table, leaf_agg_eligible
from ..utils.config import device_of, run_name, validate_config
from ..utils.logging import MetricsWriter, initialize_logger
from ..utils.profiling import tree_edges_per_batch
from . import steps as S

def not_yet_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to noise_gnn_tpu_torch")


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
        for key, what in (("resume", "resume"), ("do_plot", "do_plot: true")):
            if config.get(key):
                raise not_yet_ported(what)
        if int(config.get("ckpt_every", 0)) > 0:
            raise not_yet_ported("checkpointing (ckpt_every > 0)")
        if not config.get("do_train", True):
            raise not_yet_ported("do_train: false")
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
        self._csr = g.csr(self.device)
        t1 = time.perf_counter()
        self._flip_labels()
        self.logger.info(
            f"   setup: load_network {self._t_load:.1f}s, CSR + device placement "
            f"{t1 - t0:.1f}s, noise {time.perf_counter() - t1:.1f}s on {self.device}"
        )
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

    def epoch_seed_matrix(self, idx: np.ndarray, batch_size: int):
        """All of an epoch's padded seed batches as [nsteps, B] device
        tensors (seeds int64, mask bool); consumes the host rng exactly as
        the JAX package does."""
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
        aggregate of the raw features (built here if training did not)."""
        f = self.data.x.shape[-1]
        x_agg = self._fused_table(self._agg_kind(spec))[:, f:]
        return FullGraphInference(spec, self.data.csr, x_agg=x_agg)

    def make_eval(self, spec):
        accs = split_accuracy_fn(self.split_idx, self._y, self.graph.num_nodes)
        infer = self._make_infer(spec)

        def evaluate(params):
            return accs(infer(params, self.data.x))

        return evaluate

    def make_eval_pair(self, spec):
        """Fused dual-model evaluation: one [N, 2H] SpMM per layer serves
        both co-teaching nets."""
        accs = split_accuracy_fn(self.split_idx, self._y, self.graph.num_nodes)
        infer = self._make_infer(spec)

        def evaluate2(p1, p2):
            l1, l2 = infer.pair(p1, p2, self.data.x)
            return accs(l1), accs(l2)

        return evaluate2

    def spec_for(self, module: str | None = None) -> nets.NetSpec:
        c = self.config
        spec = nets.make_network({**c, "module": module or c["module"]},
                                 c["nbr_features"], c["nbr_classes"])
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
                     run_loss=None, run_fit=None) -> bool:
        """True = re-enter the run's epoch loop with fresh inits (the noise
        realization stays fixed, so paired A/Bs stay paired): the run's
        selection never found signal, or its optimization collapsed, and
        ``reinit_retries`` allows another attempt."""
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
        self.logger.info(f"{c['num_runs']} RUNS")
        results = {}
        if c["train_type"] in ("nalgo", "both"):
            results["nalgo"] = self._loop_ct()
        if c["train_type"] in ("baseline", "both"):
            results["baseline"] = self._loop_baseline()
        return results

    def _loop_ct(self):
        c = self.config
        spec = self.spec_for()
        algo = "codi" if c["algo_type"] == "codi" else "coteaching"
        exact = self.exact_leaf_on(spec)
        evaluate_pair = self.make_eval_pair(spec)
        train_idx = self.split_idx["train"]
        bs = int(c["batch_size"])
        edges_per_batch = tree_edges_per_batch(bs, self.fanouts)
        best_accs, test_hists, reinits, pure_hist = [], [], [], []
        for run in range(int(c["num_runs"])):
            if self.reflip_per_run:
                self._flip_labels(run)  # (seed, run)-keyed: pairs the A/B
            attempt = 0
            while True:
                s1, s2 = self.init_state(spec), self.init_state(spec)
                best1 = best2 = 0.0
                run_pure, run_test, run_loss, run_fit = [], [], [], []
                for epoch in range(int(c["max_epochs"])):
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
                    if c["epoch_logger"] and not ((epoch + 1) % 10):
                        self.logger.info(
                            f"   Train epoch {epoch + 1}/{c['max_epochs']} --- "
                            f"acc t1: {acc1['train']:.3f} t2: {acc2['train']:.3f} "
                            f"v1: {acc1['valid']:.3f} v2: {acc2['valid']:.3f} "
                            f"tst1: {acc1['test']:.3f} tst2: {acc2['test']:.3f}")
                self.logger.info(
                    f"   RUN {run + 1} - best nalgo test acc1: {best1:.3f}   acc2: {best2:.3f}")
                if self._degen_retry(run, attempt, run_pure, max(best1, best2),
                                     run_loss=run_loss, run_fit=run_fit):
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
