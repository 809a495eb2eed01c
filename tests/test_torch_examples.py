"""The port's examples on the CPU: ``examples/torch_serve_farm.py`` (two
weighted tenants on one ``FarmScheduler``, a stream under a window of 8,
a service joining mid-run), ``examples/torch_train_lm.py`` (a
llama-family model on the Markov stream, checkpoint and restart, the
loss dropping by more than a nat) and ``examples/torch_autotune.py``
(``sim://`` sweeps, the tuning cache, dispatch through it), each run as a
subprocess with ``--device cpu`` and small flags; none imports ``jax`` or
``repro``."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(example, *args):
    """Run ``examples/<example>`` as ``__main__`` with ``args``, then fail
    if the process imported jax or the reference package.  Returns its
    standard output."""
    path = str(ROOT / "examples" / example)
    code = ("import runpy, sys\n"
            f"sys.argv = [{path!r}] + {list(args)!r}\n"
            f"runpy.run_path({path!r}, run_name='__main__')\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_serve_farm_example_runs_on_the_cpu():
    out = _run("torch_serve_farm.py", "--reduced", "--device", "cpu")
    assert "[interactive] 16 requests served" in out
    assert "[batch] 48 requests x 6 new tokens" in out
    assert "elastic-0 joined" in out and "[pool] services=3" in out
    assert out.rstrip().endswith("OK")


def test_train_lm_example_runs_on_the_cpu():
    out = _run("torch_train_lm.py", "--device", "cpu", "--steps", "150", "--vocab", "128",
               "--layers", "2", "--d-model", "128", "--batch", "8", "--seq-len", "32")
    assert "restarted at step 75" in out
    assert out.rstrip().endswith("OK")


def test_autotune_example_runs_on_the_cpu():
    """The port's autotune example: sim:// sweeps with the scripted cost
    model (the reference's own xla_flash winner and the bf16 flash tiles'),
    the cache written, and the windowed dispatch reading it on the CPU."""
    out = _run("torch_autotune.py", "--device", "cpu")
    assert "xla_flash (torch): winner {'kv_chunk': 128, 'q_chunk': 128}" in out
    assert "flash_fwd (cuda): winner" in out
    assert "flash_bwd (cuda): winner" in out
    assert "windowed dispatch through the tuned chunks" in out
    assert "cache hits=1 misses=0" in out
    assert out.rstrip().endswith("OK")


@pytest.mark.parametrize("example", ["torch_serve_farm.py", "torch_train_lm.py",
                                     "torch_autotune.py", "torch_fractal_farm.py",
                                     "torch_pagerank_farm.py", "torch_quickstart.py"])
def test_examples_default_to_the_card(example):
    """Without ``--device`` an example asks for the card, and raises where
    there is none, instead of running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / example), "--reduced"]
                          if example == "torch_serve_farm.py"
                          else [sys.executable, str(ROOT / "examples" / example)],
                          env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "no CUDA device is available" in proc.stderr
