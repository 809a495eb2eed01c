"""The slice end to end on the CPU: the port's ``serve_requests`` on the
reduced qwen3 with converted parameters returns the JAX package's greedy
tokens, and no module of the port imports JAX or the reference package.

Greedy tokens can only be compared where no step is a near-tie: the
prompts (``np.random.default_rng(6)``, 8 x 16 tokens, 8 new tokens) were
chosen so that the top-2 logit gap exceeds the 2e-3 logit tolerance at
every step, and the test asserts that before comparing.
"""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import torch

import repro.configs as jcfgs
import repro_torch
import repro_torch.configs as tcfgs
from repro.core import LookupService as JLookup
from repro.core import Service as JService
from repro.models import build as jbuild
from repro.runtime.serve_loop import ServeConfig as JServeConfig
from repro.runtime.serve_loop import serve_requests as jserve
from repro_torch.core import LookupService, Service
from repro_torch.interop import params_from_jax
from repro_torch.models import build as tbuild
from repro_torch.runtime.serve_loop import ServeConfig, serve_requests

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
LOGIT_TOL = 2e-3
PROMPT, NEW, N_REQ = 16, 8, 8


def _greedy_gaps(api, model, prompts):
    """Top-2 logit gap at every greedy step of the port's generation."""
    lg, caches = api.prefill(model, {"tokens": torch.from_numpy(prompts)},
                             seq_budget=PROMPT + NEW)
    gaps = []
    for i in range(NEW):
        top2 = torch.topk(lg, 2, dim=-1).values
        gaps.append(float((top2[:, 0] - top2[:, 1]).min()))
        lg, caches = api.decode(model, {"tokens": lg.argmax(-1)[:, None],
                                        "cache_index": PROMPT + i}, caches)
    return gaps


def test_serve_requests_matches_jax_greedy_tokens():
    cfg_j = jcfgs.reduced(jcfgs.get("qwen3_1p7b"))
    cfg_t = tcfgs.reduced(tcfgs.get("qwen3_1p7b"))
    api_j, api_t = jbuild(cfg_j), tbuild(cfg_t)
    params = api_j.init(jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg_t, "cpu")
    prompts = np.random.default_rng(6).integers(0, cfg_t.vocab_size,
                                                (N_REQ, PROMPT))
    assert min(_greedy_gaps(api_t, model, prompts)) > LOGIT_TOL

    jlookup = JLookup()
    for _ in range(2):
        JService(jlookup).start()
    gen_j, _ = jserve(api_j, params, prompts,
                      JServeConfig(max_new_tokens=NEW, prompt_len=PROMPT,
                                   batch_per_task=4), lookup=jlookup)

    lookup = LookupService()
    for _ in range(2):
        Service(lookup, device="cpu").start()
    gen_t, stats = serve_requests(api_t, model, prompts,
                                  ServeConfig(max_new_tokens=NEW,
                                              prompt_len=PROMPT,
                                              batch_per_task=4),
                                  lookup=lookup)
    assert gen_t.device.type == "cpu" and gen_t.dtype == torch.int32
    assert tuple(gen_t.shape) == (N_REQ, NEW)
    np.testing.assert_array_equal(gen_t.numpy(), np.asarray(gen_j))
    assert stats["done"] == N_REQ // 4


def test_port_imports_neither_jax_nor_repro():
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    assert "repro_torch.kernels.flash_attention.flash_attention" in names
    code = ("import importlib, sys\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_serve_launcher_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-1.7b", "--reduced", "--device", "cpu", "--requests", "4",
         "--services", "2"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "generated (4, 8) on cpu" in proc.stdout
