"""The harness's shared pieces: where files go, the benchmark's data files,
seeds, the import check, the card's name, and the reduction of a profiler
trace to busy time, kernel time and idle gaps.

Nothing here imports torch at module level: ``run.py`` sets the cache
directories in the environment before torch (and Triton) first read them.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = BENCH / ".cache"

# top-level module names that must never be loaded by a benchmark run,
# compared whole: the program's package name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "noise_gnn_tpu")


def set_cache_env() -> None:
    """Every build and kernel cache at a fixed directory inside the
    checkout, so that only a checkout's first run builds."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
    # one process with few threads: the timed path is one host thread
    # driving the card
    os.environ.setdefault("OMP_NUM_THREADS", "1")


def forbidden_loaded(modules=None) -> list[str]:
    """Names in ``sys.modules`` whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def load_yaml(path: Path) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"unknown workload {name!r}")


def config_file(bench: dict, name: str) -> Path:
    for c in bench["configs"]:
        if c["name"] == name:
            return ROOT / c["file"]
    raise SystemExit(f"unknown configuration {name!r}")


def traffic_file(name: str) -> Path:
    return BENCH / "traffic" / f"{name}.yaml"


def limits_file(workload: str) -> Path:
    return BENCH / "limits" / f"{workload}.json"


def load_module(path: Path, name: str):
    """Import a file of the harness by its path (metric readers are named
    after metrics, which may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise SystemExit(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(name: str):
    return load_module(BENCH / "entries" / f"{name}.py", f"gnnbench_entry_{name}")


def reader(metric: str):
    return load_module(BENCH / "metrics" / f"{metric}.py",
                       "gnnbench_metric_" + metric.replace(".", "_"))


def derive_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one purpose (``tags``) from the run's seed."""
    import numpy as np

    ss = np.random.SeedSequence([int(seed) % (1 << 63), *tags])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def card() -> dict:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return {"card": None, "power_limit": None}
    if res.returncode != 0 or not res.stdout.strip():
        return {"card": None, "power_limit": None}
    name, limit = (s.strip() for s in res.stdout.strip().splitlines()[0].rsplit(",", 1))
    return {"card": name, "power_limit": limit}


# ------------------------------------------------------------ trace reduction


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


WINDOW_SPAN = "gnnbench.window"


def reduce_trace(events, top: int = 10) -> dict:
    """Busy time, kernel time by name and the longest idle gaps of the
    device over the traced window: the span of the host annotation
    :data:`WINDOW_SPAN` that the harness opens around the traced calls.

    ``events`` are the profiler's raw events (``kineto_results.events()``):
    device events (kernels, copies, fills) count as busy; each idle gap is
    labelled with the harness's call span and the innermost host operation
    running at its middle."""
    from torch.autograd import DeviceType

    win = [e for e in events if e.name() == WINDOW_SPAN and e.device_type() == DeviceType.CPU]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
    t0_ns, t1_ns = win[0].start_ns(), win[0].start_ns() + win[0].duration_ns()
    host_names = {e.name() for e in events if e.device_type() == DeviceType.CPU}
    dev, host = [], []
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            # a host annotation (``record_function``: the harness's spans,
            # the optimizer's step) is mirrored on the device's timeline as
            # a span over its kernels, under the host span's name: it is no
            # device work of its own
            if e.name() not in host_names:
                dev.append((e.name(), s, s + d))
        elif e.device_type() == DeviceType.CPU and d > 0 and e.name() != WINDOW_SPAN:
            host.append((e.name(), s, s + d))
    per_name: dict[str, float] = {}
    spans = []
    for name, s, e in dev:
        s, e = max(s, t0_ns), min(e, t1_ns)
        if e <= s:
            continue
        per_name[name] = per_name.get(name, 0.0) + (e - s) * 1e-9
        spans.append((s, e))
    merged = _union(spans)
    busy = sum(e - s for s, e in merged) * 1e-9
    gaps = []
    prev = t0_ns
    for s, e in merged + [(t1_ns, t1_ns)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = []
    for s, e in gaps[:top]:
        mid = (s + e) // 2
        around = [h for h in host if h[1] <= mid < h[2]]
        spans = [h[0] for h in around if h[0].startswith("gnnbench.")]
        inner = min(around, key=lambda h: h[2] - h[1])[0] if around else "no host operation"
        labelled.append([" / ".join(spans[:1] + [inner]), (e - s) * 1e-9])
    ops = sorted(per_name.items(), key=lambda kv: -kv[1])
    return {"busy_s": busy, "window_s": (t1_ns - t0_ns) * 1e-9, "kernels": per_name,
            "device_ops": [[k[:NAME_CHARS], v] for k, v in ops[:top]],
            "idle_gaps": labelled}


NAME_CHARS = 160  # a kernel's name in the breakdown: C++ signatures run to thousands
