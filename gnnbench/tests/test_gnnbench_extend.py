"""A configuration, a traffic mix and a per-layer metric are added as new
files, with entries appended to BENCHMARK.json, and a run finds them by
name; no file the benchmark has is edited."""

import json
import os
import shutil
import subprocess
import sys

from gnnbench import core

CODE = """
import sys
from gnnbench import run
sys.exit(run.main(["--workload", "products_sage_co_b256", "--seed", "31", "--seconds",
                   "0.5", "--trace", "1"], device="cpu",
                  overrides={"synthetic_scale": 1000}))
"""


def test_new_files_only(tmp_path):
    root = tmp_path / "checkout"
    skip = shutil.ignore_patterns(".cache", "__pycache__", "*.so")
    shutil.copytree(core.BENCH, root / "gnnbench", ignore=skip)
    shutil.copytree(core.ROOT / "noise_gnn_tpu_torch", root / "noise_gnn_tpu_torch", ignore=skip)
    before = {p: p.read_bytes() for p in (root / "gnnbench").rglob("*") if p.is_file()}
    bench = core.benchmark()
    b = root / "gnnbench"
    cfg = (b / "configs" / "products_sage_co.yaml").read_text()
    (b / "configs" / "products_sage_co_b256.yaml").write_text(
        cfg.replace("name: products_sage_co", "name: products_sage_co_b256")
           .replace("batch_size: 512", "batch_size: 256"))
    (b / "traffic" / "co_steps_short.yaml").write_text(
        "entry: ct_step\npipeline: PipelineCO\nschedule_epoch: 5\ncheck_steps: 3\n"
        "warm_calls: 1\ntrace_seconds: 0.5\n")
    (b / "metrics" / "calls_per_s.py").write_text(
        "def read(m):\n    return m.calls / m.window_s\n")
    (b / "limits" / "products_sage_co_b256.json").write_text(
        (b / "limits" / "products_sage_co.json").read_text())
    bench["configs"].append({**bench["configs"][0], "name": "products_sage_co_b256",
                             "file": "gnnbench/configs/products_sage_co_b256.yaml"})
    bench["workloads"].append({"name": "products_sage_co_b256",
                               "config": "products_sage_co_b256",
                               "traffic": "co_steps_short", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "products_sage_co" in m.get("workloads", []):
            m["workloads"].append("products_sage_co_b256")
    bench["per_layer"].append({"name": "calls_per_s", "unit": "1/s", "better": "higher",
                               "source": "host_clock", "layer": "train step",
                               "moves": "train_nodes_per_s",
                               "workloads": ["products_sage_co_b256"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    env = {**os.environ, "PYTHONPATH": str(root)}
    out = subprocess.run([sys.executable, "-c", CODE], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["metrics"]["calls_per_s"]["value"] > 0
    assert "step_mfu" in res["metrics"]
    after = {p: p.read_bytes() for p in before}
    assert after == before
