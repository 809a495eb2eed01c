"""The port's vision LM (phi-3-vision's backbone with its CLIP-frontend
stub) against the JAX package at reduced size.

A batch may carry precomputed ``patch_embeds`` (B, P, d_model): the model
projects them by ``patch_proj`` and places them before the text tokens.
Parameters come from the JAX package's ``api.init(PRNGKey(0))`` through
``params_from_jax``.  Prefill logits with P patches and T tokens, then 4
teacher-forced decode steps at cache_index P + T + i (as the reference's
``test_models_smoke.py`` steps), within 2e-3; ``train_loss`` (text
positions only) within 2e-4; the JAX side on its XLA backend and on its
Pallas kernels in interpret mode.  Served text-only, as the reference's
``serve_requests`` builds tasks, the greedy tokens equal the JAX
package's.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro_torch.configs as tcfgs
from repro import kernels as jkernels
from repro.models import build as jbuild
from repro_torch.interop import params_from_jax
from repro_torch.models import build as tbuild


@pytest.fixture(autouse=True)
def _torch_threads():
    """One intra-op thread for each test of this file, the previous count
    afterwards, as in the other tight-tolerance port tests."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ARCH = "phi3_vision_4p2b"
TOL, LOSS_TOL = 2e-3, 2e-4
B, T = 2, 12


@pytest.fixture(scope="module")
def models():
    cfg_j = jcfgs.reduced(jcfgs.get(ARCH))
    cfg_t = tcfgs.reduced(tcfgs.get(ARCH))
    api_j, api_t = jbuild(cfg_j), tbuild(cfg_t)
    params = api_j.init(jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg_t, "cpu")
    return api_j, params, api_t, model


def _backend(name):
    return (jkernels.backend("pallas", interpret=True) if name == "pallas"
            else contextlib.nullcontext())


def _patches(cfg, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.n_patch_tokens, cfg.d_model), np.float32)


@pytest.mark.parametrize("jax_backend", ["xla", "pallas"])
def test_prefill_with_patches_and_decode_match_jax(models, jax_backend):
    api_j, params, api_t, model = models
    cfg = api_t.cfg
    P = cfg.n_patch_tokens
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, T + 4))
    pe = _patches(cfg, 4)
    budget = P + T + 8
    with _backend(jax_backend):
        lg_j, caches_j = api_j.prefill(
            params, {"tokens": jnp.asarray(tokens[:, :T]), "patch_embeds": jnp.asarray(pe)},
            seq_budget=budget)
        lg_t, caches_t = api_t.prefill(
            model, {"tokens": torch.from_numpy(tokens[:, :T]),
                    "patch_embeds": torch.from_numpy(pe)}, seq_budget=budget)
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=TOL, rtol=TOL,
                                   err_msg="prefill")
        assert tuple(caches_t[0]["k"].shape) == (B, budget, cfg.n_kv_heads, cfg.head_dim)
        for i in range(4):
            step = tokens[:, T + i:T + i + 1]
            lg_j, caches_j = api_j.decode(
                params, {"tokens": jnp.asarray(step, jnp.int32),
                         "cache_index": jnp.asarray(P + T + i, jnp.int32)}, caches_j)
            lg_t, caches_t = api_t.decode(
                model, {"tokens": torch.from_numpy(step), "cache_index": P + T + i},
                caches_t)
            np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=TOL,
                                       rtol=TOL, err_msg=f"step {i}")


@pytest.mark.parametrize("jax_backend", ["xla", "pallas"])
def test_train_loss_on_text_positions_matches_jax(models, jax_backend):
    api_j, params, api_t, model = models
    cfg = api_t.cfg
    rng = np.random.default_rng(5)
    tokens, targets = (rng.integers(0, cfg.vocab_size, (B, 16)) for _ in range(2))
    pe = _patches(cfg, 6)
    with _backend(jax_backend):
        loss_j, _ = api_j.train_loss(params, {"tokens": jnp.asarray(tokens),
                                              "targets": jnp.asarray(targets),
                                              "patch_embeds": jnp.asarray(pe)})
    batch = {"tokens": torch.from_numpy(tokens), "targets": torch.from_numpy(targets),
             "patch_embeds": torch.from_numpy(pe)}
    loss_t, _ = api_t.train_loss(model, batch)
    np.testing.assert_allclose(float(loss_t), float(loss_j), atol=LOSS_TOL, rtol=LOSS_TOL)
    # the patches change the text positions' loss, and the loss covers
    # only those (a text-only batch's loss differs)
    del batch["patch_embeds"]
    assert abs(float(api_t.train_loss(model, batch)[0]) - float(loss_t)) > 1e-4


def test_text_only_greedy_tokens_match_jax(models):
    """Text prompts, as ``serve_requests`` builds tasks in both packages:
    8 greedy tokens through the port's generate program equal the JAX
    package's.  Greedy tokens compare only where no step is a near-tie:
    the prompts (``default_rng(29)``) were chosen so that the top-2 logit
    gap exceeds the 2e-3 logit tolerance at every step, asserted first."""
    from repro.runtime.serve_loop import ServeConfig as JServeConfig
    from repro.runtime.serve_loop import make_generate_program as jprogram
    from repro_torch.runtime.serve_loop import ServeConfig, make_generate_program

    api_j, params, api_t, model = models
    prompts = np.random.default_rng(29).integers(0, api_t.cfg.vocab_size, (4, 16))
    new = 8
    lg, caches = api_t.prefill(model, {"tokens": torch.from_numpy(prompts)},
                               seq_budget=16 + new)
    gaps = []
    for i in range(new):
        top2 = torch.topk(lg, 2, dim=-1).values
        gaps.append(float((top2[:, 0] - top2[:, 1]).min()))
        lg, caches = api_t.decode(model, {"tokens": lg.argmax(-1)[:, None],
                                          "cache_index": 16 + i}, caches)
    assert min(gaps) > TOL
    gen_j = jprogram(api_j, JServeConfig(max_new_tokens=new, prompt_len=16), params).fn(
        {"tokens": jnp.asarray(prompts)})["generated"]
    gen_t = make_generate_program(api_t, ServeConfig(max_new_tokens=new, prompt_len=16),
                                  model).fn({"tokens": torch.from_numpy(prompts)})["generated"]
    np.testing.assert_array_equal(gen_t.numpy(), np.asarray(gen_j))


def test_patch_projection_is_carried_across(models):
    _, params, _, model = models
    np.testing.assert_array_equal(model.patch_proj.detach().numpy(),
                                  np.asarray(params["patch_proj"]["w"]))
