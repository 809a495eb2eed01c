"""The port's dense GQA models against the JAX package at reduced size.

The JAX package's ``api.init(PRNGKey(0))`` parameters go through
``params_from_jax``; prefill logits and 4 teacher-forced decode steps must
match within 2e-3 (the reference's own serve-consistency tolerance),
with the JAX side on its default XLA backend and on its Pallas kernels in
interpret mode.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro_torch.configs as tcfgs
from repro import kernels as jkernels
from repro.models import build as jbuild
from repro.models.attention import chunked_attention as jchunked
from repro.models.attention import decode_attention_xla as jdecode_xla
from repro_torch.interop import params_from_jax
from repro_torch.models import build as tbuild
from repro_torch.models.attention import chunked_attention, decode_attention_xla

torch.set_num_threads(2)

ARCHS = ["qwen3_1p7b", "llama3p2_1b"]
TOL = 2e-3


def _models(arch):
    cfg_j = jcfgs.reduced(jcfgs.get(arch))
    cfg_t = tcfgs.reduced(tcfgs.get(arch))
    api_j, api_t = jbuild(cfg_j), tbuild(cfg_t)
    params = api_j.init(jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg_t, "cpu")
    return api_j, params, api_t, model


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_mirror_the_reference(arch):
    for full in (True, False):
        cj, ct = jcfgs.get(arch), tcfgs.get(arch)
        if not full:
            cj, ct = jcfgs.reduced(cj), tcfgs.reduced(ct)
        for f in dataclasses.fields(ct):
            if f.name == "pattern":
                assert [(b.mixer, b.mlp, b.window) for b in ct.pattern] == \
                       [(b.mixer, b.mlp, b.window) for b in cj.pattern]
            else:
                assert getattr(ct, f.name) == getattr(cj, f.name), f.name


@pytest.mark.parametrize("jax_backend", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(arch, jax_backend):
    api_j, params, api_t, model = _models(arch)
    cfg = api_t.cfg
    B, T = 2, 12
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, T + 4))
    ctx = (jkernels.backend("pallas", interpret=True)
           if jax_backend == "pallas" else contextlib.nullcontext())
    with ctx:
        lg_j, caches_j = api_j.prefill(params, {"tokens": jnp.asarray(tokens[:, :T])},
                                       seq_budget=T + 8)
        lg_t, caches_t = api_t.prefill(model, {"tokens": torch.from_numpy(tokens[:, :T])},
                                       seq_budget=T + 8)
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=TOL,
                                   rtol=TOL, err_msg=f"{arch} prefill")
        for i in range(4):
            step = tokens[:, T + i:T + i + 1]
            lg_j, caches_j = api_j.decode(
                params, {"tokens": jnp.asarray(step, jnp.int32),
                         "cache_index": jnp.asarray(T + i, jnp.int32)}, caches_j)
            lg_t, caches_t = api_t.decode(
                model, {"tokens": torch.from_numpy(step), "cache_index": T + i},
                caches_t)
            assert lg_t.dtype == torch.float32 and lg_t.shape == (B, cfg.vocab_size)
            np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=TOL,
                                       rtol=TOL, err_msg=f"{arch} step {i}")


def test_prefill_pads_cache_to_budget():
    _, _, api_t, model = _models("qwen3_1p7b")
    cfg = api_t.cfg
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 5)))
    _, caches = api_t.prefill(model, {"tokens": tokens}, seq_budget=9)
    assert len(caches) == cfg.n_layers
    for c in caches:
        assert tuple(c["k"].shape) == (2, 9, cfg.n_kv_heads, cfg.head_dim)
        assert torch.count_nonzero(c["k"][:, 5:]) == 0
        assert torch.count_nonzero(c["v"][:, 5:]) == 0
    fresh = api_t.make_caches(model, 2, 9)
    assert tuple(fresh[0]["v"].shape) == (2, 9, cfg.n_kv_heads, cfg.head_dim)


def test_attention_ops_are_passed_to_every_layer():
    """The entry points hand their ``ops`` pair down to each layer: a
    recording pair over the plain versions is called once per layer and
    gives the default dispatch's logits (both plain on the CPU)."""
    from repro_torch.kernels import PLAIN, AttentionOps

    _, _, api_t, model = _models("qwen3_1p7b")
    cfg = api_t.cfg
    calls = {"prefill": 0, "decode": 0}

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    ops = AttentionOps(counted("prefill", PLAIN.prefill),
                       counted("decode", PLAIN.decode))
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 6)))
    lg, caches = api_t.prefill(model, {"tokens": tokens}, seq_budget=8)
    lg_o, caches_o = api_t.prefill(model, {"tokens": tokens}, seq_budget=8, ops=ops)
    step = {"tokens": tokens[:, -1:], "cache_index": 6}
    lg2, _ = api_t.decode(model, step, caches)
    lg2_o, _ = api_t.decode(model, step, caches_o, ops=ops)
    assert calls == {"prefill": cfg.n_layers, "decode": cfg.n_layers}
    torch.testing.assert_close(lg_o, lg, rtol=0, atol=0)
    torch.testing.assert_close(lg2_o, lg2, rtol=0, atol=0)
    q = torch.zeros(1, 4, 2, 32)
    with pytest.raises(NotImplementedError, match="window"):
        PLAIN.prefill(q, q, q, causal=True, window=2)


@pytest.mark.parametrize("window", [None, 8])
def test_plain_references_match_jax(window):
    """``chunked_attention`` / ``decode_attention_xla``: the XLA path's
    references, which also serve windowed attention on the CPU."""
    rng = np.random.default_rng(5)
    B, S, H, K, D = 2, 32, 4, 2, 16
    q, k, v = (rng.standard_normal(s, np.float32)
               for s in ((B, S, H, D), (B, S, K, D), (B, S, K, D)))
    ref = jchunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                   window=window, q_chunk=8, kv_chunk=16)
    got = chunked_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                            window=window, q_chunk=8, kv_chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)
    q1 = q[:, :1]
    ref = jdecode_xla(jnp.asarray(q1), jnp.asarray(k), jnp.asarray(v),
                      cache_index=20, window=window)
    got = decode_attention_xla(*map(torch.from_numpy, (q1, k, v)),
                               cache_index=20, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)
