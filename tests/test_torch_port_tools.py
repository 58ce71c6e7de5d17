"""The port's measuring and evidence tools (``noise_gnn_tpu_torch/tools/``)
against the JAX package's tools, on the CPU at tiny sizes.

Each measuring tool runs with ``--cpu`` and gives every key of its JSON
line, finite; without ``--cpu`` and without a card each raises. The halo
byte counts, the evidence suite's rows, harvest and report table equal the
JAX tools' (loaded by path, as ``tests/test_evidence_harvest.py`` loads
``tools/evidence.py``); ``bench_spmm``'s graph gives the JAX
``gather_scatter_mean`` from the port's plain SpMM; ``bench_scaling``'s
edges a batch are JAX's ``tree_edges_per_batch``. The card's own case is
``tests/test_torch_port_gpu.py::test_bench_spmm_small_on_cuda``.
"""

import importlib.util
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from noise_gnn_tpu_torch.ops.spmm import spmm_reference
from noise_gnn_tpu_torch.tools import (bench_scaling, bench_spmm, bench_trainstep, evidence,
                                       halo_accounting, plot_curves, plot_metrics,
                                       profile_step)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _finite_numbers(d):
    """Every number in a nest of dicts and lists (booleans aside)."""
    if isinstance(d, dict):
        return [v for x in d.values() for v in _finite_numbers(x)]
    if isinstance(d, list):
        return [v for x in d for v in _finite_numbers(x)]
    return [d] if isinstance(d, (int, float)) and not isinstance(d, bool) else []


def _assert_cpu_line(res: dict):
    assert res["card"] == "cpu" and res["power_limit"] is None
    nums = _finite_numbers(res)
    assert nums and all(math.isfinite(v) for v in nums)


# ------------------------------------------------------------- bench_spmm

BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "vs_baseline_one_jit", "vs_torch_sparse",
              "sol_fraction", "bound_ms", "bound_by", "bound_fraction", "single_edges_per_s", "chained_edges_per_s",
              "dual_stream_model_edges_per_s", "baseline_edges_per_s",
              "baseline_chained_edges_per_s", "torch_sparse_edges_per_s", "ms",
              "baseline_chunks", "torch_sparse_dtype", "nodes", "edges", "feat", "dtype",
              "iters", "chain", "card", "power_limit"}


def test_bench_spmm_cpu_line():
    res = bench_spmm.run(cpu=True, nodes=2000, edges=20000, feat=8)
    assert set(res) == BENCH_KEYS
    assert res["metric"] == "spmm_edges_per_s_per_chip" and res["unit"] == "edges/s"
    assert set(res["ms"]) == {"single", "chained", "dual", "baseline", "baseline_chained",
                              "torch_sparse"}
    assert (res["nodes"], res["edges"], res["baseline_chunks"]) == (2000, 20000, 1)
    _assert_cpu_line(res)
    assert res["value"] == max(res[k] for k in ("single_edges_per_s", "chained_edges_per_s",
                                                "baseline_edges_per_s",
                                                "baseline_chained_edges_per_s"))
    # the --cpu cut of bench.py:66-67
    assert bench_spmm.main(["--cpu", "--nodes", "2000", "--edges", "20000", "--feat", "4",
                            "--iters", "1"]) == 0


def test_bench_spmm_graph_plain_matches_jax():
    """bench.py's graph (the same numpy draws) through the port's plain SpMM
    and JAX ``gather_scatter_mean`` (bench.py's reference mechanism), f32."""
    import jax.numpy as jnp

    from noise_gnn_tpu.ops.scatter import gather_scatter_mean

    n, e, f = 2000, 20000, 8
    indptr, src, counts = bench_spmm.make_graph(n, e)
    rng = np.random.default_rng(0)
    # bench.py:79-83 draws the sources, then the destinations, from one rng
    assert np.array_equal(src, rng.integers(0, n, e).astype(np.int32))
    assert np.array_equal(counts, np.bincount(rng.integers(0, n, e), minlength=n))
    x = np.random.default_rng(1).standard_normal((n, f)).astype(np.float32)
    got = spmm_reference(torch.from_numpy(indptr), torch.from_numpy(src), torch.from_numpy(x))
    dst = np.repeat(np.arange(n, dtype=np.int32), counts)
    want = gather_scatter_mean(jnp.asarray(x), jnp.stack([jnp.asarray(src), jnp.asarray(dst)]),
                               n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


# ---------------------------------------------- bench_trainstep, profile_step

TINY = dict(nodes=3000, deg=4, feat=8, classes=5, hidden=16, batch=32, fanouts=(3, 2), steps=2,
            reps=1)


def test_bench_trainstep_cpu_line():
    res = bench_trainstep.run(cpu=True, **TINY)
    assert set(res["modes"]) == {"sampled", "exact"}
    for row in res["modes"].values():
        assert row["ms_per_step"] > 0 and row["tree_edges_per_s"] > 0
    assert "leaf_table_s" in res["modes"]["exact"]
    assert res["tree_edges_per_batch"] == 32 * 3 + 32 * 3 * 2
    _assert_cpu_line(res)


def test_profile_step_cpu_line():
    res = profile_step.run(cpu=True, **TINY)
    # the JAX tool's stage names (tools/profile_step.py:236-246), the pair
    # forward named for how the port runs it
    jax_names = ["rng_only", "gathers_only(fixed idx)", "sample_only", "sample+gather",
                 "+forward x1 (no dropout)", "+forward x1", "+forward x2 + ct_loss",
                 "full step (grad+update x2)"]
    names = [r["stage"] for r in res["stages"]]
    assert [n for n in names if n in jax_names] == jax_names and len(names) == 9
    assert "+fwd x2 with autograd (as ct_step) + ct_loss" in names
    for r in res["stages"]:
        assert r["ms_per_step"] is None and math.isfinite(r["wall_ms_per_step"])
    _assert_cpu_line(res)


# ---------------------------------------------------------- bench_scaling


# two gloo rank processes take ~10 s of a busy worker: slow
@pytest.mark.parametrize("world", [(1,), pytest.param((1, 2), marks=pytest.mark.slow)])
def test_bench_scaling_gloo_ranks(world, monkeypatch):
    from noise_gnn_tpu.utils.profiling import tree_edges_per_batch

    monkeypatch.setattr(bench_scaling, "RANK_TIMEOUT_S", 120.0)
    res = bench_scaling.run(cpu=True, world=world, nodes=500, feat=8, hidden=8,
                            batch_per_device=4, iters=2)
    assert set(res["rates_edges_per_s"]) == set(world)
    assert res["backend"] == ({1: None, 2: "gloo"} if 2 in world else {1: None})
    assert res["scaling_number"] is False and res["shared_card"] is False
    for n in world:
        assert res["edges_per_batch"][n] == tree_edges_per_batch(4 * n, (15, 10, 5))
    assert res["efficiency"][1] == 1.0
    _assert_cpu_line(res)


# -------------------------------------------------------- halo_accounting


@pytest.mark.parametrize("reorder", [False, True])
def test_halo_accounting_matches_jax(reorder, monkeypatch, capsys):
    argv = ["--dataset", "cora", "--scale", "10", "--shards", "4"] + (["--reorder"] if reorder
                                                                      else [])
    jax_tool = _jax_tool("halo_accounting")
    monkeypatch.setattr(sys, "argv", ["halo_accounting.py", *argv])
    jax_tool.main()
    want = json.loads(capsys.readouterr().out)
    assert halo_accounting.main(["--cpu", *argv]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    counts = ["shards", "reorder", "nodes", "edges", "boundary_rows_total",
              "boundary_fraction_of_nodes", "alltoall_bytes_actual", "wire_bytes_offdiag",
              "alltoall_bytes_padded", "ppermute_rounds_bytes", "replicated_psum_equiv_bytes",
              "comm_reduction_vs_psum"]
    assert {k: got[k] for k in counts} == {k: want[k] for k in counts}
    assert set(got) == set(counts) | {"card", "power_limit"}  # no rate without one given
    res = halo_accounting.run(cpu=True, shards=4, dataset="cora", scale=10, reorder=reorder,
                              link_bytes_per_s=1e9, spmm_edges_per_s=1e8)
    assert res["per_rank_exchange_s"] == got["wire_bytes_offdiag"] / 4 / 1e9
    assert 0 < res["predicted_scaling_efficiency"] < 1


# --------------------------------------------------------------- evidence


@pytest.fixture(scope="module")
def jax_evidence():
    return _jax_tool("evidence")


def test_evidence_rows_match_jax(jax_evidence):
    assert evidence.MATRIX == jax_evidence.MATRIX
    assert evidence.MATRIX_BIG == jax_evidence.MATRIX_BIG
    labels = [m[0] for m in evidence.select_rows(False, "pubmed, ogbn-arxiv CTP,cora sym 0.45")]
    assert labels == ["pubmed rand_pair 0.4 co-teaching vs CE", "ogbn-arxiv CTP consistency",
                      "cora sym 0.45 co-teaching vs CE", "cora sym 0.45 backward-correction vs CE",
                      "cora sym 0.45 CoDis"]
    assert evidence.select_rows(True, None) == evidence.MATRIX


def test_evidence_harvest_matches_jax(jax_evidence, tmp_path):
    mdir = tmp_path / "out" / "metrics"
    pdir = tmp_path / "out" / "pure"
    mdir.mkdir(parents=True)
    pdir.mkdir(parents=True)
    stale = [{"event": "epoch_ct", "run": 0, "epoch": i, "test_acc_1": 0.1, "ts": 100.0 + i}
             for i in range(3)]
    fresh = [{"event": "epoch_ct", "run": 0, "epoch": i, "test_acc_1": 0.5 + i / 10,
              "noisy_fit_1": 0.01 * i, "label": "x", "ts": 1000.0 + i} for i in range(600)]
    fresh += [{"event": "epoch_baseline", "run": 1, "epoch": i, "test_acc": 0.4, "ts": 1000.0}
              for i in range(4)]
    fresh += [{"event": "warmup", "epoch": 0, "loss": 1.5, "ts": 1001.0},
              {"event": "summary_nalgo", "mean": 0.6, "std": 0.01, "ts": 1010.0},
              {"event": "reinit_degenerate", "run": 0, "ts": 1011.0}]
    (mdir / "rowX.jsonl").write_text("\n".join(json.dumps(e) for e in stale + fresh)
                                     + "\nnot json\n")
    np.save(mdir / "confusion_rowX.npy", np.arange(9, dtype=np.int64).reshape(3, 3))
    np.save(pdir / "rowX.npy", np.linspace(0, 1, 7))
    cfg = {"_output_name": "rowX", "out_dir": str(tmp_path / "out"),
           "_harvest_after_ts": 1000.0}
    got = evidence._harvest_artifacts(cfg)
    assert got == jax_evidence._harvest_artifacts(cfg)
    assert set(got) == {"_events", "_curves", "_pure", "_confusion"}
    assert evidence._harvest_artifacts({}) == jax_evidence._harvest_artifacts({}) == {}


def _summary(mean, std):
    return {"mean": mean, "std": std, "final_mean": mean - 0.001, "final_std": std,
            "last10_mean": mean - 0.002}


def test_evidence_from_log_table_matches_jax(jax_evidence, tmp_path, monkeypatch, capsys):
    rows = {
        "cora sym 0.45 co-teaching vs CE": {"wall_s": 12.0, "nalgo": _summary(0.3605, 0.0028),
                                            "baseline": _summary(0.3618, 0.0021),
                                            "card": "some card", "power_limit": "700.00 W"},
        "cora sym 0.45 backward-correction vs CE": {"baseline": _summary(0.41, 0.004)},
        "cora sym 0.3 grid search (SG, beta x tau)": {"grid_best": {"mean": 0.371, "std": 0.0},
                                                      "grid_top3": [{"acc": 0.371}]},
        "pubmed rand_pair 0.4 co-teaching vs CE": {"error": "boom"},
        evidence._FLAG: {"nalgo": _summary(0.668, 0.038), "baseline": _summary(0.673, 0.033)},
        evidence._TAU: {"nalgo": _summary(0.722, 0.05)},
        "ogbn-arxiv contrastive pretrain/finetune": {"contrastive": {"mean": 0.307, "std": 0.0,
                                                                     "final_mean": 0.302}},
    }
    log = tmp_path / "run.log"
    log.write_text("== a label\nnot json {\n" + "\n".join(json.dumps({k: v})
                                                          for k, v in rows.items()) + "\n")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["evidence.py", "--from-log", str(log), "--out", "jax.md",
                                      "--tag", "jax"])
    jax_evidence.main()
    assert evidence.main(["--cpu", "--from-log", str(log), "--out", "port.md",
                          "--tag", "port"]) == 0
    capsys.readouterr()

    def first_table(path):
        lines = Path(path).read_text().splitlines()
        start = next(i for i, line in enumerate(lines) if line.startswith("| Experiment"))
        end = next(i for i in range(start, len(lines)) if not lines[i].startswith("|"))
        return lines[start:end]

    jax_table = first_table("jax.md")
    assert first_table("port.md") == jax_table and len(jax_table) == 2 + 16
    assert len(list((tmp_path / "docs" / "evidence" / "port").glob("*.json"))) == 16
    # beside docs/RESULTS.md: 0.3605 +- 0.0028 against JAX's 0.360 +- 0.003
    beside = [line for line in Path("port.md").read_text().splitlines()
              if line.startswith("| cora sym 0.45 co-teaching vs CE | some card | nalgo")]
    assert len(beside) == 1 and beside[0].endswith("| yes |")
    # the JAX report and an existing tag directory are never written
    with pytest.raises(ValueError):
        evidence.main(["--cpu", "--from-log", str(log), "--out", str(evidence.JAX_RESULTS)])
    with pytest.raises(FileExistsError):
        evidence.main(["--cpu", "--from-log", str(log), "--out", "again.md", "--tag", "port"])


ONE_OV = {"synthetic_scale": 10, "max_epochs": 2, "num_runs": 1, "train_type": "both",
          "compare_loss": "normal", "hidden_size": 16, "nbr_neighbors": [3, 2]}
# what JAX's run_one gives on ONE_OV (test_evidence_one_row_keys_match_jax)
ONE_KEYS = {"wall_s", "nalgo", "baseline", "_events", "_curves", "_pure"}


def _port_one(tmp_path, capsys) -> dict:
    ov = dict(ONE_OV, out_dir=str(tmp_path / "port"))
    assert evidence.main(["--cpu", "--one", json.dumps({"base": "config_cora.yml",
                                                        "ov": ov})]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_evidence_one_row_cpu(tmp_path, capsys):
    row = _port_one(tmp_path, capsys)
    assert set(row) == ONE_KEYS | {"card", "power_limit"}
    assert row["card"] == "cpu"
    for b in ("nalgo", "baseline"):
        assert 0 <= row[b]["mean"] <= 1 and row[b]["std"] == 0.0
    assert set(row["_curves"]) == {"epoch_ct_r0", "epoch_baseline_r0"}
    assert row["_curves"]["epoch_ct_r0"]["epoch"] == [0, 1]


@pytest.mark.slow
def test_evidence_one_row_keys_match_jax(jax_evidence, tmp_path, capsys):
    """The port's ``--one`` row against JAX ``run_one`` on the same override:
    the same keys, branch summaries, curves and their fields, events."""
    got = _port_one(tmp_path, capsys)
    want = jax_evidence.run_one("config_cora.yml",
                                dict(ONE_OV, device="cpu", out_dir=str(tmp_path / "jax")))
    assert set(want) == ONE_KEYS
    assert set(got) - {"card", "power_limit"} == set(want)
    for b in ("nalgo", "baseline"):
        assert set(got[b]) == set(want[b])
    assert {k: set(v) for k, v in got["_curves"].items()} == \
        {k: set(v) for k, v in want["_curves"].items()}
    assert [e["event"] for e in got["_events"]] == [e["event"] for e in want["_events"]]
    assert np.shape(got["_pure"]) == np.shape(want["_pure"])


# ----------------------------------------------------- the device rule, plots


@pytest.mark.parametrize("tool", [bench_spmm, bench_trainstep, profile_step, bench_scaling,
                                  halo_accounting, evidence])
def test_tools_raise_without_card_or_cpu(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tool.main([])


def _curves_artifact(path: Path) -> None:
    curves = {"epoch_ct_r0": {"epoch": [0, 1, 2], "test_acc_1": [0.1, 0.2, 0.3],
                              "test_acc_2": [0.1, 0.25, 0.3]},
              "epoch_baseline_r0": {"epoch": [0, 1, 2], "test_acc": [0.1, 0.15, 0.2]}}
    path.write_text(json.dumps({"label": "row", "result": {"_curves": curves}}))


def test_plot_tools_nothing_to_plot(tmp_path, capsys):
    """The plot scripts' entries on inputs with no curve (no matplotlib)."""
    m = tmp_path / "run.jsonl"
    m.write_text(json.dumps({"event": "setup", "load_s": 0.1}) + "\n")
    assert plot_metrics.main([str(m)]) == 0
    (tmp_path / "row.json").write_text(json.dumps({"label": "row", "result": {"nalgo": {}}}))
    assert plot_curves.main([str(tmp_path)]) == 0
    assert capsys.readouterr().out == "nothing to plot\n"


@pytest.mark.slow
def test_plot_tools_write_pngs(tmp_path, capsys):
    m = tmp_path / "metrics" / "run.jsonl"
    m.parent.mkdir()
    m.write_text("\n".join(json.dumps({"event": "epoch_ct", "epoch": i, "loss_1": 1.0 / (i + 1),
                                       "test_acc_1": 0.1 * i}) for i in range(3)) + "\n")
    out = tmp_path / "p.png"
    assert plot_metrics.main([str(m), "-o", str(out)]) == 0
    _curves_artifact(tmp_path / "00_row.json")
    assert plot_curves.main([str(tmp_path)]) == 0
    assert out.exists() and (tmp_path / "curves_00_row.png").exists()
    assert capsys.readouterr().out.splitlines() == [f"wrote {out}",
                                                    str(tmp_path / "curves_00_row.png")]
