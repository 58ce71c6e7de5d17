"""Run one cell of the benchmark and print its result line.

    python -m gnnbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration (``configs/<config>.yaml``), its traffic mix
(``traffic/<mix>.yaml``, which names the entry ``entries/<entry>.py`` that
drives the program), each metric's reader (``metrics/<metric>.py``) and the
limits of its check (``limits/<cell>.json``). A run builds the program's
set-up, runs the check's first steps, warms up, measures for ``--seconds``
(with ``--trace 1``, then a short profiled window), frees the program's
state, judges what the timed path produced against the plain reference
(``reference/``), and prints one JSON line. It prints no result, and exits
non-zero, without enough CUDA cards, or if JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

from gnnbench import core  # noqa: E402

core.set_cache_env()


def _window(drv, seconds: float, cuda: bool):
    """Calls back to back until ``seconds`` have passed and the entry is at
    a boundary; (units, calls, seconds, device ms between call starts)."""
    import torch

    starts = []
    units = calls = 0
    t0 = time.perf_counter()
    while True:
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            starts.append(ev)
        u, boundary = drv.call()
        units += u
        calls += 1
        if boundary and time.perf_counter() - t0 >= seconds:
            break
    if cuda:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize()
        starts.append(end)
    elapsed = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in zip(starts, starts[1:])]
    return units, calls, elapsed, step_ms


def _traced(drv, seconds: float, cuda: bool) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with record_function(core.WINDOW_SPAN):
            units, calls, elapsed, _ = _window(drv, seconds, cuda)
    red = core.reduce_trace(prof.profiler.kineto_results.events())
    red.update(units=units, calls=calls)
    return red


def _metrics(bench: dict, name: str, part: str) -> list[dict]:
    return [m for m in bench[part] if name in m.get("workloads", [name])]


def main(argv=None, *, device: str | None = None, overrides: dict | None = None) -> int:
    """The CLI; ``device`` and ``overrides`` let the tests run a cell on
    the CPU at a small size (the CLI always asks for CUDA cards)."""
    ap = argparse.ArgumentParser(prog="python -m gnnbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = core.benchmark()
    w = core.cell(bench, args.workload)
    cfg = core.load_yaml(core.config_file(bench, w["config"]))
    mix = core.load_yaml(core.traffic_file(w["traffic"]))

    import torch

    cuda = device is None
    if cuda:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(w["chips"]):
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"gnnbench: {args.workload} needs {w['chips']} CUDA card(s), found {n}",
                  file=sys.stderr)
            return 2
        device = "cuda"
        torch.cuda.reset_peak_memory_stats()
    try:
        import noise_gnn_tpu_torch
    except ImportError as e:
        print(f"gnnbench: the program is not importable: {e}", file=sys.stderr)
        return 2
    where = Path(noise_gnn_tpu_torch.__file__).resolve().parent.parent
    if where != core.ROOT:
        print(f"gnnbench: the program was imported from {where}, not from this checkout",
              file=sys.stderr)
        return 2
    from gnnbench import bind

    ctx = bind.Ctx(w, cfg, mix, args.seed, device, overrides)
    drv = core.entry(mix["entry"]).build(ctx)
    drv.check(int(mix["check_steps"]))
    for _ in range(int(mix["warm_calls"])):
        drv.call()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0

    # the timed path is one host thread driving the card: keep it on one
    # core through the windows (the set-up's native threads were free)
    cores = os.sched_getaffinity(0)
    os.sched_setaffinity(0, {max(cores)})
    f0 = drv.flops_done
    units, calls, elapsed, step_ms = _window(drv, args.seconds, cuda)
    flops = drv.flops_done - f0
    if step_ms:
        q = statistics.quantiles(step_ms, n=20) if len(step_ms) > 1 else step_ms * 19
        print(f"window {calls} calls in {elapsed!r} s; ms between call starts: "
              f"p5 {q[0]!r} p50 {q[9]!r} p95 {q[18]!r}", file=sys.stderr)
    trace = _traced(drv, float(mix["trace_seconds"]), cuda) if args.trace else None
    peak = (max(torch.cuda.max_memory_allocated(d) for d in range(int(w["chips"])))
            if cuda else 0)
    os.sched_setaffinity(0, cores)

    m = types.SimpleNamespace(  # what the metric readers read
        setup_s=setup_s, setup_record=ctx.setup_record, units=units, calls=calls,
        window_s=elapsed, step_ms=step_ms, flops=flops, peak_bytes=peak, trace=trace, drv=drv,
        unit=drv.unit)
    values = {}
    for spec in _metrics(bench, args.workload, "per_layer" if args.trace else "end_to_end"):
        v = core.reader(spec["name"]).read(m)
        if v is not None:
            values[spec["name"]] = {"value": v, "unit": spec["unit"]}

    drv.finish()
    if cuda:
        torch.cuda.empty_cache()
    readings = drv.verify()
    lim_path = core.limits_file(args.workload)
    limits = json.loads(lim_path.read_text())["limits"] if lim_path.exists() else {}
    # a reading with no limit (no control or fault separates it from sound
    # runs) is printed but not compared
    checks = {k: {"value": readings[k], "limit": v} for k, v in limits.items() if k in readings}
    correct = bool(checks) and len(checks) == len(limits) and all(
        c["value"] <= c["limit"] for c in checks.values())
    for k in sorted(set(readings) - set(limits)):
        print(f"reading {k} {readings[k]!r} (not compared)", file=sys.stderr)

    bad = core.forbidden_loaded()
    if bad:
        print(f"gnnbench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(w["chips"]), "memory_peak_bytes": int(peak)}
    if cuda:
        dev["power_limit"] = core.card()["power_limit"]
    result = {"correct": correct, "attempted": calls, "failed": 0, "metrics": values,
              "device": dev}
    if trace is not None:
        dev.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
        result["breakdown"] = {"device_ops": trace["device_ops"],
                               "idle_gaps": trace["idle_gaps"]}
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
