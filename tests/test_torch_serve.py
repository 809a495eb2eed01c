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
import pytest
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


@pytest.fixture(autouse=True)
def _torch_threads():
    """One intra-op thread for each test of this file, the previous count
    afterwards (set per test, not at import: every xdist worker imports
    every test file).  On the CPUs these tests run on, torch's second
    thread has been seen under load to compute exp on its half of a
    tensor with errors far above an ulp, which breaks the tight
    tolerances here at random; with one thread it has not."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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


def test_generate_program_hands_the_whole_payload_to_prefill():
    """Both packages' generate programs pass every key of a task's payload
    to prefill (the port moving each tensor to the parameters' device),
    so a model's prefill sees its extra inputs (whisper's ``enc_frames``,
    a vision model's ``patch_embeds``)."""
    import dataclasses

    import jax.numpy as jnp

    from repro.runtime.serve_loop import make_generate_program as jprogram
    from repro_torch.runtime.serve_loop import make_generate_program

    cfg_j = jcfgs.reduced(jcfgs.get("qwen3_1p7b"))
    cfg_t = tcfgs.reduced(tcfgs.get("qwen3_1p7b"))
    api_j, api_t = jbuild(cfg_j), tbuild(cfg_t)
    params = api_j.init(jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg_t, "cpu")
    tokens = np.random.default_rng(7).integers(0, cfg_t.vocab_size, (2, PROMPT))
    extra = np.arange(6, dtype=np.float32).reshape(2, 3)
    seen = {}

    def recording(prefill, tag):
        def call(p, batch, **kw):
            seen[tag] = batch
            return prefill(p, {"tokens": batch["tokens"]}, **kw)
        return call

    sc = ServeConfig(max_new_tokens=2, prompt_len=PROMPT)
    jprogram(dataclasses.replace(api_j, prefill=recording(api_j.prefill, "jax")),
             JServeConfig(max_new_tokens=2, prompt_len=PROMPT), params).fn(
        {"tokens": jnp.asarray(tokens), "extra": jnp.asarray(extra)})
    out = make_generate_program(
        dataclasses.replace(api_t, prefill=recording(api_t.prefill, "torch")), sc, model).fn(
        {"tokens": torch.from_numpy(tokens), "extra": torch.from_numpy(extra)})
    assert sorted(seen["jax"]) == sorted(seen["torch"]) == ["extra", "tokens"]
    assert seen["torch"]["extra"].device == model.device
    np.testing.assert_array_equal(seen["torch"]["extra"].numpy(), extra)
    assert tuple(out["generated"].shape) == (2, 2)


def test_serve_config_has_the_references_fields_and_defaults():
    """``ServeConfig(greedy=True)`` constructs in both packages, whose
    dataclasses name the same fields with the same defaults."""
    import dataclasses

    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(ServeConfig) == fields(JServeConfig)
    assert ("greedy", True) in fields(ServeConfig)
    assert ServeConfig(greedy=True) == ServeConfig()
    JServeConfig(greedy=True)


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
