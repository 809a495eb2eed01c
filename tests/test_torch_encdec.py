"""The port's whisper encoder-decoder against the JAX package at reduced
size.

A batch carries precomputed encoder frames ``enc_frames`` (B, S_enc,
d_model), the reference's frontend stub.  Parameters come from the JAX
package's ``api.init(PRNGKey(0))`` through ``params_from_jax``, which
unstacks the reference's ``encoder``/``decoder`` trees along their
leading layer axis.  Prefill logits and 4 teacher-forced decode steps
within 2e-3, ``train_loss`` within 2e-4, the JAX side on its XLA backend
and on its Pallas kernels in interpret mode; greedy tokens through the
port's generate program, on tasks that carry ``enc_frames``, equal the
reference's.
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


ARCH = "whisper_tiny"
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


def _frames(cfg, seed, batch=B):
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.encoder_seq_len, cfg.d_model), np.float32)


@pytest.mark.parametrize("jax_backend", ["xla", "pallas"])
def test_prefill_and_decode_logits_match_jax(models, jax_backend):
    api_j, params, api_t, model = models
    cfg = api_t.cfg
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, T + 4))
    frames = _frames(cfg, 4)
    with _backend(jax_backend):
        lg_j, caches_j = api_j.prefill(
            params, {"tokens": jnp.asarray(tokens[:, :T]), "enc_frames": jnp.asarray(frames)},
            seq_budget=T + 8)
        lg_t, caches_t = api_t.prefill(
            model, {"tokens": torch.from_numpy(tokens[:, :T]),
                    "enc_frames": torch.from_numpy(frames)}, seq_budget=T + 8)
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=TOL, rtol=TOL,
                                   err_msg="prefill")
        for i in range(4):
            step = tokens[:, T + i:T + i + 1]
            lg_j, caches_j = api_j.decode(
                params, {"tokens": jnp.asarray(step, jnp.int32),
                         "cache_index": jnp.asarray(T + i, jnp.int32)}, caches_j)
            lg_t, caches_t = api_t.decode(
                model, {"tokens": torch.from_numpy(step), "cache_index": T + i}, caches_t)
            assert lg_t.dtype == torch.float32 and lg_t.shape == (B, cfg.vocab_size)
            np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=TOL,
                                       rtol=TOL, err_msg=f"step {i}")
    # the static cross cache is each layer's K/V of the encoder output
    for layer in range(cfg.n_layers):
        np.testing.assert_allclose(caches_t[layer]["cross"]["k"].numpy(),
                                   np.asarray(caches_j["cross"]["k"][layer]),
                                   atol=TOL, rtol=TOL)


@pytest.mark.parametrize("jax_backend", ["xla", "pallas"])
def test_train_loss_matches_jax(models, jax_backend):
    api_j, params, api_t, model = models
    cfg = api_t.cfg
    rng = np.random.default_rng(5)
    tokens, targets = (rng.integers(0, cfg.vocab_size, (B, 16)) for _ in range(2))
    frames = _frames(cfg, 6)
    with _backend(jax_backend):
        loss_j, _ = api_j.train_loss(params, {"tokens": jnp.asarray(tokens),
                                              "targets": jnp.asarray(targets),
                                              "enc_frames": jnp.asarray(frames)})
    loss_t, _ = api_t.train_loss(model, {"tokens": torch.from_numpy(tokens),
                                         "targets": torch.from_numpy(targets),
                                         "enc_frames": torch.from_numpy(frames)})
    np.testing.assert_allclose(float(loss_t), float(loss_j), atol=LOSS_TOL, rtol=LOSS_TOL)


def test_greedy_tokens_through_the_generate_program_match_jax(models):
    """Tasks that carry ``enc_frames`` beside the prompt, through each
    package's generate program: the port's hands the whole payload to
    prefill, as the reference's does.  Greedy tokens compare only where no
    step is a near-tie: the prompts and frames (``default_rng(8)``,
    ``default_rng(9)``) were chosen so that the top-2 logit gap exceeds
    the 2e-3 logit tolerance at every step, asserted first."""
    from repro.runtime.serve_loop import ServeConfig as JServeConfig
    from repro.runtime.serve_loop import make_generate_program as jprogram
    from repro_torch.runtime.serve_loop import ServeConfig, make_generate_program

    api_j, params, api_t, model = models
    prompt, new = 16, 8
    prompts = np.random.default_rng(8).integers(0, api_t.cfg.vocab_size, (4, prompt))
    frames = _frames(api_t.cfg, 9, batch=4)
    payload = {"tokens": torch.from_numpy(prompts), "enc_frames": torch.from_numpy(frames)}
    lg, caches = api_t.prefill(model, payload, seq_budget=prompt + new)
    gaps = []
    for i in range(new):
        top2 = torch.topk(lg, 2, dim=-1).values
        gaps.append(float((top2[:, 0] - top2[:, 1]).min()))
        lg, caches = api_t.decode(model, {"tokens": lg.argmax(-1)[:, None],
                                          "cache_index": prompt + i}, caches)
    assert min(gaps) > TOL
    gen_j = jprogram(api_j, JServeConfig(max_new_tokens=new, prompt_len=prompt), params).fn(
        {"tokens": jnp.asarray(prompts), "enc_frames": jnp.asarray(frames)})["generated"]
    gen_t = make_generate_program(api_t, ServeConfig(max_new_tokens=new, prompt_len=prompt),
                                  model).fn(payload)["generated"]
    np.testing.assert_array_equal(gen_t.numpy(), np.asarray(gen_j))


def test_kernel_calls_per_prefill_and_decode_step(models):
    """Prefill calls the flash dispatch once a layer of the encoder
    (non-causal), and twice a decoder layer (causal self-attention, then
    non-causal cross-attention of T queries over S_enc keys); a decode
    step calls the decode dispatch once a decoder layer (self-attention)
    and nothing for the cross-attention, which stays plain."""
    _, _, api, model = models
    cfg = api.cfg
    calls = []

    def prefill(q, k, v, **kw):
        calls.append(("prefill", q.shape[1], k.shape[1], kw["causal"]))
        return PLAIN.prefill(q, k, v, **kw)

    def decode(q, k, v, **kw):
        calls.append(("decode", k.shape[1], kw["cache_index"]))
        return PLAIN.decode(q, k, v, **kw)

    ops = AttentionOps(prefill, decode)
    batch = {"tokens": torch.zeros((B, 5), dtype=torch.int64),
             "enc_frames": torch.from_numpy(_frames(cfg, 10))}
    _, caches = api.prefill(model, batch, seq_budget=9, ops=ops)
    S = cfg.encoder_seq_len
    assert calls == ([("prefill", S, S, False)] * cfg.n_encoder_layers
                     + [("prefill", 5, 5, True), ("prefill", 5, S, False)] * cfg.n_layers)
    calls.clear()
    api.decode(model, {"tokens": batch["tokens"][:, :1], "cache_index": 5}, caches, ops=ops)
    assert calls == [("decode", 9, 5)] * cfg.n_layers
    fresh = api.make_caches(model, B, 7)
    assert tuple(fresh[0]["self"]["k"].shape) == (B, 7, cfg.n_kv_heads, cfg.head_dim)
    assert tuple(fresh[0]["cross"]["v"].shape) == (B, S, cfg.n_kv_heads, cfg.head_dim)


def test_params_from_jax_unstacks_layers_and_refuses_a_mismatch(models):
    _, params, api, model = models
    tree = jax.tree.map(np.asarray, params)
    for layer in range(api.cfg.n_encoder_layers):
        np.testing.assert_array_equal(model.encoder[layer].attn.wq.detach().numpy(),
                                      tree["encoder"]["attn"]["wq"][layer])
        np.testing.assert_array_equal(model.encoder[layer].mlp_norm.bias.detach().numpy(),
                                      tree["encoder"]["mlp_norm"]["bias"][layer])
    for layer in range(api.cfg.n_layers):
        np.testing.assert_array_equal(model.decoder[layer].cross_attn.wo.detach().numpy(),
                                      tree["decoder"]["cross_attn"]["wo"][layer])
    bad = jax.tree.map(lambda a: a, tree)
    bad["decoder"]["mlp"]["wi"] = tree["decoder"]["mlp"]["wi"][:, :, :-1]
    with pytest.raises(ValueError, match="decoder/mlp/wi"):
        params_from_jax(bad, api.cfg, "cpu")
    extra = jax.tree.map(lambda a: a, tree)
    extra["decoder"]["mlp"]["wg"] = tree["decoder"]["mlp"]["wi"]
    with pytest.raises(ValueError, match="decoder/mlp/wg"):
        params_from_jax(extra, api.cfg, "cpu")
