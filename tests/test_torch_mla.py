"""The port's MiniCPM family against the JAX package at reduced size:
minicpm3-4b (MLA: multi-head latent attention) and minicpm-2b (an MHA
decoder with a tied head).

The JAX package's ``api.init(PRNGKey(0))`` parameters go through
``params_from_jax``.  Prefill logits and 4 teacher-forced decode steps
must match within 2e-3 (the reference's own serve-consistency tolerance)
and ``train_loss`` within 2e-4, with the JAX side on its XLA backend and
on its Pallas kernels in interpret mode.  MLA's prefill is the
materialised path through the flash kernel's dispatch with D = nope +
rope and Dv = v_head_dim (at full width 96 and 64); its decode is the
absorbed form against the latent cache, with no kernel.
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
from repro_torch.kernels import PLAIN, AttentionOps
from repro_torch.models import build as tbuild


@pytest.fixture(autouse=True)
def _torch_threads():
    """One intra-op thread for each test of this file, the previous count
    afterwards, as in the other tight-tolerance port tests."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ARCHS = ["minicpm3_4b", "minicpm_2b"]
TOL, LOSS_TOL = 2e-3, 2e-4
B, T = 2, 12


def _models(arch):
    cfg_j = jcfgs.reduced(jcfgs.get(arch))
    cfg_t = tcfgs.reduced(tcfgs.get(arch))
    api_j, api_t = jbuild(cfg_j), tbuild(cfg_t)
    params = api_j.init(jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg_t, "cpu")
    return api_j, params, api_t, model


def _backend(name):
    return (jkernels.backend("pallas", interpret=True) if name == "pallas"
            else contextlib.nullcontext())


@pytest.mark.parametrize("jax_backend", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(arch, jax_backend):
    api_j, params, api_t, model = _models(arch)
    cfg = api_t.cfg
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, T + 4))
    with _backend(jax_backend):
        lg_j, caches_j = api_j.prefill(params, {"tokens": jnp.asarray(tokens[:, :T])},
                                       seq_budget=T + 8)
        lg_t, caches_t = api_t.prefill(model, {"tokens": torch.from_numpy(tokens[:, :T])},
                                       seq_budget=T + 8)
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=TOL, rtol=TOL,
                                   err_msg=f"{arch} prefill")
        for i in range(4):
            step = tokens[:, T + i:T + i + 1]
            lg_j, caches_j = api_j.decode(
                params, {"tokens": jnp.asarray(step, jnp.int32),
                         "cache_index": jnp.asarray(T + i, jnp.int32)}, caches_j)
            lg_t, caches_t = api_t.decode(
                model, {"tokens": torch.from_numpy(step), "cache_index": T + i}, caches_t)
            assert lg_t.dtype == torch.float32 and lg_t.shape == (B, cfg.vocab_size)
            np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=TOL,
                                       rtol=TOL, err_msg=f"{arch} step {i}")


@pytest.mark.parametrize("jax_backend", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_matches_jax(arch, jax_backend):
    api_j, params, api_t, model = _models(arch)
    rng = np.random.default_rng(4)
    tokens, targets = (rng.integers(0, api_t.cfg.vocab_size, (B, 16)) for _ in range(2))
    with _backend(jax_backend):
        loss_j, _ = api_j.train_loss(params, {"tokens": jnp.asarray(tokens),
                                              "targets": jnp.asarray(targets)})
    loss_t, metrics = api_t.train_loss(model, {"tokens": torch.from_numpy(tokens),
                                               "targets": torch.from_numpy(targets)})
    assert float(metrics["aux_loss"]) == 0.0
    np.testing.assert_allclose(float(loss_t), float(loss_j), atol=LOSS_TOL, rtol=LOSS_TOL)


def test_absorbed_decode_matches_materialised_prefill():
    """The reference's consistency check on the port alone: each absorbed
    decode step against the latent cache gives the logits of a
    materialised prefill over the prompt so far."""
    _, _, api, model = _models("minicpm3_4b")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, api.cfg.vocab_size, (B, T + 4)))
    lg, caches = api.prefill(model, {"tokens": tokens[:, :T]}, seq_budget=T + 8)
    for i in range(4):
        lg, caches = api.decode(model, {"tokens": tokens[:, T + i:T + i + 1],
                                        "cache_index": T + i}, caches)
        ref, _ = api.prefill(model, {"tokens": tokens[:, :T + i + 1]})
        torch.testing.assert_close(lg, ref, atol=TOL, rtol=TOL, msg=f"step {i}")


def test_mla_caches_and_the_head_dims_its_prefill_passes():
    """The latent cache is padded to the budget; prefill hands the flash
    dispatch q and k of nope + rope dims and a contiguous v of
    v_head_dim dims, one call a layer; decode calls no attention op."""
    _, _, api, model = _models("minicpm3_4b")
    cfg = api.cfg
    seen = []

    def prefill(q, k, v, **kw):
        seen.append((q.shape[-1], k.shape[-1], v.shape[-1], v.is_contiguous(),
                     kw["causal"]))
        return PLAIN.prefill(q, k, v, **kw)

    def decode(*a, **kw):
        raise AssertionError("MLA's absorbed decode calls no attention op")

    ops = AttentionOps(prefill, decode)
    tokens = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (B, 5)))
    _, caches = api.prefill(model, {"tokens": tokens}, seq_budget=9, ops=ops)
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    assert seen == [(nope + rope, nope + rope, cfg.v_head_dim, True, True)] * cfg.n_layers
    for c in caches:
        assert tuple(c["c_kv"].shape) == (B, 9, cfg.kv_lora_rank)
        assert tuple(c["k_rope"].shape) == (B, 9, rope)
        assert torch.count_nonzero(c["c_kv"][:, 5:]) == 0
    api.decode(model, {"tokens": tokens[:, -1:], "cache_index": 5}, caches, ops=ops)
    assert torch.count_nonzero(caches[0]["c_kv"][:, 5]) > 0
    fresh = api.make_caches(model, B, 7)
    assert tuple(fresh[0]["k_rope"].shape) == (B, 7, rope)
