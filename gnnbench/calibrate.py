"""Readings for setting a cell's limits: the check's numbers for the
program on many seeds, for the control (the reference computed one
precision below the configuration's) and for planted faults, all in one
process (one set-up), written as JSON lines.

    python -m gnnbench.calibrate --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] --out <file.jsonl>

Benchmark runs never run this; its readings set ``limits/<cell>.json``.
Faults: ``half_batch`` (the reference with half of each batch left out, the
mean over the rest) for training cells; ``answer_altered`` (one node's
logits of net 1 changed where they are produced, its worst class made its
best) for the eval cell.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from gnnbench import core

core.set_cache_env()

CONTROL = {"bfloat16": "float8", "float32": "tf32"}


def _ints(s: str) -> list[int]:
    return [int(v) for v in s.split(",") if v.strip()]


def main(argv=None, *, device: str = "cuda", overrides: dict | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(prog="python -m gnnbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    from gnnbench import bind
    from gnnbench.reference.precision import Precision

    bench = core.benchmark()
    w = core.cell(bench, args.workload)
    cfg = core.load_yaml(core.config_file(bench, w["config"]))
    mix = core.load_yaml(core.traffic_file(w["traffic"]))
    seeds = _ints(args.seeds)
    ctl, flt = set(_ints(args.control_seeds)), set(_ints(args.fault_seeds))
    ctx = bind.Ctx(w, cfg, mix, seeds[0], device, overrides)
    drv = core.entry(mix["entry"]).build(ctx)
    control = Precision(CONTROL[drv.spec.compute_dtype])
    rows = []

    def emit(seed, kind, r, t0, detail=None):
        row = {"workload": args.workload, "seed": seed, "kind": kind, "readings": r,
               "seconds": time.perf_counter() - t0}
        if detail:
            row["detail"] = detail
        rows.append(row)
        print(json.dumps(row), flush=True)

    train = hasattr(drv, "ref_steps")
    for i, seed in enumerate(seeds):
        if i:
            drv.start(seed)
        t0 = time.perf_counter()
        if train:
            drv.check(int(mix["check_steps"]))
            ref = drv.ref_steps(Precision())
            emit(seed, "program", drv.program_readings(ref), t0,
                 drv.worst_leaves(drv.program_out(), ref))
            if seed in ctl:
                t0 = time.perf_counter()
                r = {"labels": 0.0}
                t = drv.table_reading(control)
                if t is not None:
                    r["leaf_table"] = t
                low = drv.ref_steps(control)
                r.update(drv.readings(low, ref))
                emit(seed, "control:" + control.kind, r, t0, drv.worst_leaves(low, ref))
            if seed in flt:
                t0 = time.perf_counter()
                r = drv.readings(drv.ref_steps(Precision(), fault="half_batch"), ref)
                emit(seed, "fault:half_batch", r, t0)
        else:
            drv.call()
            drv.call()
            logits = drv.program_logits()
            ref = drv.ref_logits(Precision())
            emit(seed, "program", drv.readings(logits, drv.accs, ref), t0)
            if seed in ctl:
                t0 = time.perf_counter()
                low = drv.ref_logits(control)
                emit(seed, "control:" + control.kind,
                     drv.readings(low, [drv.split_accs(low)], ref), t0)
            if seed in flt:
                t0 = time.perf_counter()
                bad = [lg.clone() for lg in logits]
                worst = int(ref[0][0].argmin())
                bad[0][0, worst] = bad[0][0].max() + 1.0
                emit(seed, "fault:answer_altered",
                     drv.readings(bad, drv.accs, ref), t0)
            del logits, ref
        if device == "cuda":
            torch.cuda.empty_cache()
    keys = sorted({k for r in rows for k in r["readings"]})
    summary = {}
    for k in keys:
        prog = [r["readings"][k] for r in rows if r["kind"] == "program" and k in r["readings"]]
        other = {}
        for r in rows:
            if r["kind"] != "program" and k in r["readings"]:
                other.setdefault(r["kind"], []).append(r["readings"][k])
        summary[k] = {"program_max": max(prog) if prog else None,
                      **{f"{kind}_min": min(v) for kind, v in other.items()}}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
            f.write(json.dumps({"workload": args.workload, "summary": summary}) + "\n")
    return rows


if __name__ == "__main__":
    main()
    sys.exit(0)
