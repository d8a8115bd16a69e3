"""No run loads JAX or the JAX package; names are compared whole at
the top level."""
import subprocess
import sys

from pibench import guard

from conftest import ROOT


def test_whole_top_level_names():
    assert guard.forbidden_modules(["repro_torch", "repro_torch.api",
                                    "reprox", "jax_like"]) == []
    assert guard.forbidden_modules(["repro.core", "numpy"]) == ["repro"]
    assert guard.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen",
                                    "repro"]) == ["flax", "jax", "jaxlib",
                                                  "repro"]


def test_a_run_loads_neither():
    """Everything a run imports, in a fresh interpreter: the harness,
    every metric reader, the program's public facade and its kernels."""
    code = (
        "import sys; sys.path[0:0] = [%r, %r]\n"
        "import pibench.harness, pibench.spec\n"
        "import repro_torch.api, repro_torch.kernels.batched_filter_agg\n"
        "import importlib.util\n"
        "for p in (pibench.spec.PACKAGE / 'metrics').glob('*.py'):\n"
        "    s = importlib.util.spec_from_file_location('m', p)\n"
        "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
        "from pibench.guard import forbidden_modules\n"
        "print(forbidden_modules())\n"
    ) % (str(ROOT), str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card():
    """On a machine with no card the command exits non-zero and prints
    no result line."""
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, "pibench/run.py", "--workload",
                          "narrow-rh-shift", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
