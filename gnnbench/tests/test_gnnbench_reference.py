"""The plain reference against the program at small sizes on the CPU, and
the import rules: nothing a run loads is JAX or the JAX package, and the
reference loads nothing of the program."""

import json
import subprocess
import sys

import pytest

from gnnbench import core
from gnnbench.tests.common import run_cell

ROOT = str(core.ROOT)


@pytest.mark.parametrize("cell", ["products_sage_co", "arxiv_sagepl_te", "arxiv_sagepl_warm"])
def test_train_reference_follows_the_program_in_float32(cell, capsys):
    """With the program in float32 every draw is replayed and the reference
    agrees to round-off: losses, first gradients and updates."""
    rc, res = run_cell(cell, 5, overrides={"compute_dtype": "float32"}, capsys=capsys)
    assert rc == 0
    checks = {k: v["value"] for k, v in res["checks"].items()}
    assert checks["labels"] == 0
    for k in ("loss", "loss_step1", "contrast", "contrast_step1", "grad", "grad_median",
              "update", "update_median", "leaf_table"):
        if k in checks:
            assert checks[k] < 1e-5, (k, checks[k])


def test_eval_reference_follows_the_program_in_float32(capsys):
    rc, res = run_cell("products_sage_eval", 6, overrides={"compute_dtype": "float32"},
                       capsys=capsys)
    assert rc == 0
    checks = {k: v["value"] for k, v in res["checks"].items()}
    assert checks["top1_gap"] < 1e-4 and checks["logits"] < 1e-5 and checks["acc"] == 0


@pytest.mark.parametrize("cell", ["products_sage_co", "products_sage_eval"])
def test_cells_correct_at_their_precision(cell, capsys):
    rc, res = run_cell(cell, 7, capsys=capsys)
    assert rc == 0 and res["correct"], res["checks"]


def _loaded(code: str) -> list[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted(sys.modules)))"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_imports_nothing_of_the_program():
    mods = _loaded("import gnnbench.reference.train, gnnbench.reference.rewire, "
                   "gnnbench.reference.noise, gnnbench.reference.compare")
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"jax", "jaxlib", "flax", "noise_gnn_tpu", "noise_gnn_tpu_torch"}


def test_a_run_loads_no_jax(capsys):
    """run.main exits 3 if a forbidden module is loaded; a CPU run exits 0,
    and every entry, with the program, loads none."""
    rc, _ = run_cell("arxiv_sagepl_warm", 8, capsys=capsys)
    assert rc == 0
    mods = _loaded("from gnnbench import core\n"
                   "[core.entry(n) for n in ('ct_step', 'te_epoch', 'eval_pair')]\n"
                   "import noise_gnn_tpu_torch.train.pipelines")
    assert not core.forbidden_loaded(mods)


def test_forbidden_names_compared_whole():
    assert core.forbidden_loaded(["noise_gnn_tpu_torch", "noise_gnn_tpu_torch.ops",
                                  "jaxtyping", "numpy"]) == []
    assert core.forbidden_loaded(["noise_gnn_tpu.ops", "jax._src", "flax"]) == [
        "flax", "jax._src", "noise_gnn_tpu.ops"]
