"""Evidence suite: the noise-robust algorithms against plain CE, A/B on the
same graphs and injected noise, run by the port on a CUDA card.

    python -m noise_gnn_tpu_torch.tools.evidence            # every row
    python -m noise_gnn_tpu_torch.tools.evidence --quick    # the small datasets
    python -m noise_gnn_tpu_torch.tools.evidence --only "cora sym 0.45,pubmed"

Port of ``tools/evidence.py``, with its rows (``MATRIX``, ``MATRIX_BIG``),
its ``run_one``, its artifact harvest and its report, dispatched through
``noise_gnn_tpu_torch.main.main``. The criterion is the reference's: the
best-epoch test accuracy, mean +- std over runs. Each row runs in a process
of its own (``--one``), within the row's ``_timeout``.

What differs from the JAX tool:

* it writes ``docs/RESULTS_H100.md`` and ``docs/evidence/h100/`` by
  default (``--out``, ``--tag``); it refuses ``docs/RESULTS.md`` and a tag
  directory that exists already;
* the report's table has the JAX report's format, line for line; a second
  table stands each row beside the ``docs/RESULTS.md`` row of the same
  label. A row is consistent when every branch both reports is within
  max(0.02, 2 x the larger std) of JAX's;
* each row's result carries the ``card`` and ``power_limit`` it ran on;
* a row that fails or times out is reported as an ERROR row as in JAX, and
  then the tool exits 1 (``--from-log``'s rows missing from the log are
  skipped, as in JAX);
* ``--only`` takes comma-separated substrings, and runs the rows in the
  order of the substrings;
* ``--cpu`` runs every row on the CPU (``device: 'cpu'``).
* the JAX tool's ``--from-artifacts`` and ``--refresh`` are not copied:
  ``--from-log`` is the one way to build a report from earlier runs.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time

from ..utils.config import load_config
from .common import ROOT, card_info, tool_device

JAX_RESULTS = ROOT / "docs" / "RESULTS.md"


def run_one(base_cfg: str, overrides: dict) -> dict:
    from ..main import main as cli

    cfg = load_config(os.path.join(ROOT, "configs", base_cfg))
    cfg.update(copy.deepcopy(overrides))
    t0 = time.time()
    res = cli(cfg)
    cfg["_harvest_after_ts"] = t0  # metrics JSONL appends across sessions
    out = {"wall_s": round(time.time() - t0, 1)}
    if isinstance(res, dict) and "test" in res:  # PipelineCT: final accs dict
        res = {"contrastive": (float(res["test"]), 0.0)}
    if isinstance(res, tuple):  # train_type 'nalgo'/'baseline' alone
        res = {overrides.get("train_type", "nalgo") or "nalgo": res}
    if isinstance(res, list):  # PipelineSG grid rows
        rounded = [
            {k: (round(float(v), 4) if isinstance(v, (int, float)) else v)
             for k, v in r.items()} for r in res
        ]
        out["grid_top3"] = rounded[:3]
        out["grid_full"] = rounded  # every cell, one auditable object
        res = {"grid_best": (float(res[0]["acc"]), 0.0)}
    if isinstance(res, dict) and "best_val" in res:  # PipelineA
        res = {"analysis_best_val": (float(res["best_val"]), 0.0)}
    for branch, val in (res or {}).items():
        if isinstance(val, tuple) and len(val) == 2:
            out[branch] = {"mean": round(val[0], 4), "std": round(val[1], 4)}
            # RunSummary extras: per-run bests, FINAL-epoch accs,
            # last-10-epoch means, reinit-retry audit trail
            extra = getattr(val, "extra", None)
            if extra:
                out[branch].update({
                    k: (round(v, 4) if isinstance(v, float) else v)
                    for k, v in extra.items()
                })
        else:
            out[branch] = val
    out.update(_harvest_artifacts(cfg))
    return out


# per-epoch fields that are not curves (the JAX tool's; the port's epoch
# records also time their eval)
_CURVE_SKIP = {"event", "run", "epoch", "ts", "epoch_train_s", "epoch_eval_s", "edges_per_s"}


def _harvest_artifacts(cfg: dict) -> dict:
    """The run's raw evidence for its row artifact: its summary and reinit
    events, pure-ratio curves, per-epoch metric curves (test accuracy, train
    accuracy against the true and the noisy labels, the noisy-fit probe,
    the selection probes) and PipelineA's confusion matrix, taken from the
    gitignored out/ tree."""
    import numpy as np

    name = cfg.get("_output_name")
    if not name:
        return {}
    art: dict = {}
    mpath = os.path.join(str(cfg.get("out_dir", "out")), "metrics",
                         name + ".jsonl")
    if os.path.exists(mpath):
        events = []
        curves: dict = {}
        # the metrics JSONL is append-mode across sessions: harvest only
        # THIS invocation's events
        after_ts = float(cfg.get("_harvest_after_ts", 0.0)) - 1.0
        for line in open(mpath):
            try:
                e = json.loads(line)
            except json.JSONDecodeError:
                continue
            if float(e.get("ts", float("inf"))) < after_ts:
                continue
            ev = str(e.get("event", ""))
            if ev.startswith(("summary_", "reinit_", "grid_")):
                events.append(e)
            elif ev.startswith(("epoch_", "warmup", "finetune")):
                ckey = ev if "run" not in e else f"{ev}_r{int(e['run'])}"
                c = curves.setdefault(ckey, {"epoch": []})
                c["epoch"].append(int(e.get("epoch", len(c["epoch"]))))
                for k, v in e.items():
                    if k in _CURVE_SKIP or not isinstance(v, (int, float)):
                        continue
                    c.setdefault(k, []).append(round(float(v), 4))
        if events:
            art["_events"] = events
        if curves:
            # downsample long streams but always keep the last epoch
            for ckey, c in curves.items():
                n = len(c["epoch"])
                stride = max(1, (n + 249) // 250)
                if stride > 1:
                    idx = list(range(0, n, stride))
                    if idx[-1] != n - 1:
                        idx.append(n - 1)
                    curves[ckey] = {k: [v[i] for i in idx]
                                    for k, v in c.items()}
            art["_curves"] = curves
    ppath = os.path.join(str(cfg.get("out_dir", "out")), "pure",
                         name + ".npy")
    if os.path.exists(ppath):
        pure = np.load(ppath)
        art["_pure"] = np.round(pure.astype(float), 4).tolist()
    cpath = os.path.join(str(cfg.get("out_dir", "out")), "metrics",
                         "confusion_" + name + ".npy")
    if os.path.exists(cpath):
        art["_confusion"] = np.load(cpath).astype(int).tolist()
    return art


# (row label, base config, overrides): the JAX tool's rows
# (tools/evidence.py:140-236). train_type 'both' = noise-robust algorithm
# AND plain-CE baseline on identical data/noise/splits.
MATRIX = [
    ("cora sym 0.45 co-teaching vs CE", "config_cora.yml",
     dict(train_type="both", noise_type="sym", noise_rate=0.45,
          compare_loss="normal", num_runs=3, batch_id=90, max_epochs=100)),
    ("cora sym 0.45 backward-correction vs CE", "config_cora.yml",
     dict(train_type="baseline", noise_type="sym", noise_rate=0.45,
          compare_loss="back", num_runs=3, batch_id=91, max_epochs=100)),
    ("cora sym 0.45 CoDis", "config_cora.yml",
     dict(train_type="nalgo", algo_type="codi", noise_type="sym",
          noise_rate=0.45, num_runs=3, batch_id=92, max_epochs=100)),
    ("pubmed rand_pair 0.4 co-teaching vs CE", "config_pubmed.yml",
     dict(train_type="both", noise_type="rand_pair", noise_rate=0.4,
          compare_loss="normal", num_runs=3, batch_id=90)),
    ("computers sym 0.45 CoDis vs CE", "config_amazon.yml",
     dict(train_type="both", noise_type="sym", noise_rate=0.45,
          compare_loss="normal", num_runs=3, batch_id=90)),
    ("cora sym 0.3 grid search (SG, beta x tau)", "config_grid.yml",
     dict(batch_id=90, _timeout=5400)),
    ("cora sym 0.3 selection analysis (A)", "config_analysis.yml",
     dict(batch_id=90)),
]

MATRIX_BIG = [
    ("computers _test3 sym 0.5 sagePL CT+contrastive", "config_test_s.yml",
     dict(train_type="both", num_runs=2, max_epochs=100, batch_id=93,
          noise_type="sym", noise_rate=0.5)),
    ("ogbn-arxiv CTP consistency", "config_ctp.yml",
     dict(train_type="both", num_runs=3, max_epochs=60, batch_id=90)),
    ("ogbn-arxiv pseudo-label (H)", "config_h.yml",
     dict(num_runs=2, max_epochs=30, batch_id=90)),
    ("ogbn-arxiv contrastive pretrain/finetune", "config_contrast.yml",
     dict(num_runs=1, batch_id=90, warmup=20, max_epochs=40)),
    ("ogbn-arxiv contrastive (rand_pair 0.3, hid 256)", "config_contrast.yml",
     dict(num_runs=1, batch_id=94, noise_type="rand_pair", noise_rate=0.3,
          hidden_size=256, warmup=20, max_epochs=40)),
    ("ogbn-products rand_pair 0.3 co-teaching vs CE (flagship)",
     "config_products.yml",
     dict(train_type="both", compare_loss="normal", num_runs=5,
          batch_id=90, exact_leaf=True, _timeout=14400)),
    ("ogbn-products co-teaching vs CE, 100-epoch budget",
     "config_products.yml",
     dict(train_type="both", compare_loss="normal", num_runs=3,
          batch_id=95, exact_leaf=True, max_epochs=100, _timeout=21600)),
    # its paired CE baselines are the flagship row's (identical (seed,
    # run)-keyed draws and budget); main() embeds them with provenance
    ("ogbn-products co-teaching ct_tau 0.5 (discard-cost diagnostic)",
     "config_products.yml",
     dict(train_type="nalgo", num_runs=5, batch_id=96, exact_leaf=True,
          ct_tau=0.5, ckpt_every=10, resume=True, _timeout=14400)),
    ("ogbn-arxiv rand_pair 0.3 co-teaching vs CE", "config_arxiv.yml",
     dict(train_type="both", what="", module="sage", compare_loss="normal",
          num_runs=3, batch_id=90)),
]

_FLAG = "ogbn-products rand_pair 0.3 co-teaching vs CE (flagship)"
_TAU = "ogbn-products co-teaching ct_tau 0.5 (discard-cost diagnostic)"


def select_rows(quick: bool, only: str | None) -> list:
    """The rows to run: ``MATRIX_BIG + MATRIX`` (``MATRIX`` alone with
    ``quick``), filtered by ``only``'s comma-separated substrings in their
    order."""
    matrix = MATRIX if quick else MATRIX_BIG + MATRIX
    if not only:
        return list(matrix)
    rows = []
    for s in (s.strip() for s in only.split(",")):
        rows += [m for m in matrix if s and s in m[0] and m not in rows]
    return rows


def _run_row(base: str, ov: dict, cpu: bool) -> dict:
    """One row in a process of its own (``--one``), within its ``_timeout``."""
    ov = dict(ov)
    row_timeout = ov.pop("_timeout", 5400)
    payload = json.dumps({"base": base, "ov": ov})
    cmd = [sys.executable, "-m", "noise_gnn_tpu_torch.tools.evidence", "--one", payload]
    try:
        proc = subprocess.run(cmd + (["--cpu"] if cpu else []), capture_output=True, text=True,
                              timeout=row_timeout, cwd=str(ROOT))
    except subprocess.TimeoutExpired:
        return {"error": "timeout"}
    last = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    if proc.returncode == 0 and last:
        return json.loads(last[-1])
    return {"error": (proc.stderr or proc.stdout)[-500:]}


def _cell(v: dict | None, mark: str = "") -> str:
    if not (isinstance(v, dict) and "mean" in v):
        return "--"
    return f"{v['mean']:.3f} +- {v['std']:.3f}{mark}"


def _final_cell(v: dict | None) -> str:
    if not (isinstance(v, dict) and "final_mean" in v):
        return "--"
    out = f"{v['final_mean']:.3f}"
    if "final_std" in v:
        out += f" +- {v['final_std']:.3f}"
    if "last10_mean" in v:
        out += f" ({v['last10_mean']:.3f})"
    return out


def _robust(res: dict) -> list[str]:
    return [b for b in res if isinstance(res.get(b), dict) and "mean" in res[b]
            and b not in ("baseline", "paired_ce")]


def table_lines(rows: list) -> list[str]:
    """The JAX report's table, line for line."""
    lines = ["| Experiment | nalgo best | nalgo final (last10) | CE best | CE final (last10) |",
             "|---|---|---|---|---|"]
    for label, _, _, res in rows:
        # ct_tau diagnostic: its paired CE cells are the embedded flagship
        # baselines (marked *; provenance in the row artifact)
        paired = "paired_ce" in res and "baseline" not in res
        disp = dict(res)
        if paired:
            disp["baseline"] = res["paired_ce"]
        robust = _robust(res)
        rcell = ", ".join(f"{b}: {_cell(disp.get(b))}" for b in robust) or (
            "ERROR" if "error" in res else "--")
        fcell = ", ".join(_final_cell(disp.get(b)) for b in robust) or "--"
        ce = _cell(disp.get("baseline"), " \\*" if paired else "")
        lines.append(f"| {label} | {rcell} | {fcell} | {ce} | "
                     f"{_final_cell(disp.get('baseline'))} |")
    return lines


def _parse_cell(text: str) -> dict:
    """``{branch: (mean, std)}`` of a best cell of the JAX report
    ("nalgo: 0.360 +- 0.003", or "0.362 +- 0.002" for CE)."""
    out = {}
    for part in text.replace("\\*", "").split(","):
        if "+-" not in part:
            continue
        name, _, val = part.rpartition(":")
        mean, std = (float(s) for s in val.split("+-"))
        out[name.strip() or "baseline"] = (mean, std)
    return out


def jax_rows(path=JAX_RESULTS) -> dict:
    """``{label: {branch: (mean, std)}}`` of the JAX report's best cells."""
    rows = {}
    if not os.path.exists(path):
        return rows
    for line in open(path):
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if len(cells) != 5 or cells[0] in ("Experiment", "---"):
            continue
        rows[cells[0]] = {**_parse_cell(cells[1]), **_parse_cell(cells[3])}
    return rows


def beside_jax(rows: list, jax: dict) -> list[str]:
    """Each row beside the JAX report's row of the same label: per branch
    both report, the gap of the means and the tolerance max(0.02, 2 x the
    larger std)."""
    lines = ["| Experiment | Card | Branch | port best | JAX best | gap | tolerance | consistent |",
             "|---|---|---|---|---|---|---|---|"]
    for label, _, _, res in rows:
        card = res.get("card", "--")
        if "error" in res or label not in jax:
            why = "ERROR" if "error" in res else "no JAX row"
            lines.append(f"| {label} | {card} | -- | -- | -- | -- | -- | {why} |")
            continue
        branches = _robust(res) + (["baseline"] if isinstance(res.get("baseline"), dict) else [])
        for b in branches:
            if b not in jax[label]:
                continue
            (m, s), (jm, js) = (res[b]["mean"], res[b]["std"]), jax[label][b]
            gap, tol = abs(m - jm), max(0.02, 2 * max(s, js))
            lines.append(f"| {label} | {card} | {b} | {m:.3f} +- {s:.3f} | {jm:.3f} +- {js:.3f} "
                         f"| {gap:.3f} | {tol:.3f} | {'yes' if gap <= tol else 'NO'} |")
    return lines


def _pair_ct_tau(rows: list) -> None:
    """The ct_tau diagnostic's CE baselines are the flagship row's: embed
    that summary and its provenance in the diagnostic's result."""
    flag_res = next((r for l, _, _, r in rows if l == _FLAG), None)
    tau_res = next((r for l, _, _, r in rows if l == _TAU), None)
    if (flag_res and tau_res and "error" not in tau_res
            and isinstance(flag_res.get("baseline"), dict)):
        tau_res["paired_ce"] = dict(flag_res["baseline"])
        tau_res["paired_ce_provenance"] = (
            "CE cells copied from the flagship row's baseline branch: "
            "identical (seed, run)-keyed noise draws (pipelines._flip_labels "
            "is a pure function of (seed, run); batch_id only names outputs) "
            "and identical 50-epoch budget, so re-running CE here would "
            "reproduce that branch bit-for-bit."
        )


def report(rows: list, tag: str, jax: dict) -> list[str]:
    cards = sorted({f"{r['card']}, {r['power_limit']}" for *_, r in rows if "card" in r})
    lines = [
        "# RESULTS_H100 — the port's noise-robustness evidence (synthetic fallback datasets)",
        "",
        "Test accuracy, mean +- std over runs, of the PyTorch/CUDA port",
        "(`noise_gnn_tpu_torch`) on the rows of `tools/evidence.py`. `best` is",
        "best-epoch accuracy (the reference's own success criterion,",
        "src/pipeline.py:267-275); `final` is the last-epoch accuracy and",
        "`last10` the mean over the last 10 epochs. `nalgo` = the noise-robust",
        "algorithm, `baseline` = plain CE on the identical graph/noise/splits",
        "(paired draws). The datasets are the calibrated synthetic fallbacks,",
        "whose host numpy draws (graphs, splits, noise) equal the JAX package's.",
        "",
    ]
    lines += table_lines(rows)
    lines += [
        "",
        "\\* paired CE baselines copied from the flagship row (identical",
        "(seed, run)-keyed noise draws and budget; provenance embedded in",
        "the row artifact as `paired_ce_provenance`).",
        "",
        "## Beside the JAX package's rows (`docs/RESULTS.md`)",
        "",
        "A branch is consistent when its gap is at most max(0.02, 2 x the",
        "larger std). Accuracy only: no time here compares the two devices.",
        "",
    ]
    lines += beside_jax(rows, jax)
    ran = {label for label, *_ in rows}
    not_run = [label for label, *_ in MATRIX_BIG + MATRIX if label not in ran]
    lines += [
        "",
        "Rows of the matrix not run here: " + ("; ".join(not_run) if not_run else "none") + ".",
        "",
        "Raw per-row artifacts (summary events, per-run bests/finals, curves):",
        f"`docs/evidence/{tag}/*.json`. Full per-epoch streams: `out/metrics/`",
        "JSONL (gitignored).",
        "",
        "Generated by `python -m noise_gnn_tpu_torch.tools.evidence` on "
        + ("; ".join(cards) if cards else "no card") + ".",
    ]
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run every row on the CPU")
    ap.add_argument("--quick", action="store_true", help="small datasets only")
    ap.add_argument("--out", default="docs/RESULTS_H100.md")
    ap.add_argument("--one", help="(internal) run one row: JSON {base, ov}")
    ap.add_argument("--from-log", help="assemble the report from a prior run's stdout log "
                    "(no card work); rows missing from the log are skipped")
    ap.add_argument("--only", help="comma-separated substrings of row labels: the rows "
                    "that contain one, in the order of the substrings")
    ap.add_argument("--tag", default="h100", help="per-row raw JSON goes to "
                    "docs/evidence/<tag>/, which must not exist yet")
    args = ap.parse_args(argv)
    dev = tool_device(args.cpu)
    card = card_info(dev)

    if args.one:
        spec = json.loads(args.one)
        ov = dict(spec["ov"], **({"device": "cpu"} if args.cpu else {}))
        print(json.dumps({**run_one(spec["base"], ov), **card}), flush=True)
        return 0

    art_dir = os.path.join("docs", "evidence", args.tag)
    if os.path.abspath(args.out) == os.path.abspath(JAX_RESULTS):
        raise ValueError(f"{args.out} is the JAX package's report: write another file")
    if os.path.exists(art_dir):
        raise FileExistsError(f"{art_dir} exists: give a new --tag")

    logged: dict = {}
    if args.from_log:
        for line in open(args.from_log):
            line = line.strip()
            if line.startswith("{"):
                try:
                    d = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if len(d) == 1:
                    (k, v), = d.items()
                    if isinstance(v, dict):
                        logged[k] = v

    rows, failed = [], []
    for label, base, ov in select_rows(args.quick, args.only):
        if label in logged:
            rows.append((label, base, ov, logged[label]))
            continue
        if args.from_log:  # assembly only: never touch the card
            rows.append((label, base, ov, {"error": "not in log"}))
            continue
        print(f"== {label}", flush=True)
        res = _run_row(base, ov, args.cpu)
        if "error" in res:
            failed.append(label)
        print(json.dumps({label: res}), flush=True)
        rows.append((label, base, ov, res))

    _pair_ct_tau(rows)

    os.makedirs(art_dir)
    for i, (label, base, ov, res) in enumerate(rows):
        slug = "".join(ch if ch.isalnum() else "_" for ch in label)[:60]
        ov = {k: v for k, v in ov.items() if k != "_timeout"}
        with open(os.path.join(art_dir, f"{i:02d}_{slug}.json"), "w") as f:
            json.dump({"label": label, "base_config": base, "overrides": ov, "result": res},
                      f, indent=1, default=float)
    # curve plots next to the artifacts, in a process of their own
    subprocess.run([sys.executable, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                 "plot_curves.py"), art_dir], check=False)
    with open(args.out, "w") as f:
        f.write("\n".join(report(rows, args.tag, jax_rows())) + "\n")
    print(f"wrote {args.out}")
    if failed:
        print(f"{len(failed)} row(s) failed: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
