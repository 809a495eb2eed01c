"""minicpm3-4b (MLA) and phi-3-vision-4.2b in fp32 at their real head dims,
against the JAX package: the CPU side of the fp32 flash kernels at D = 96.

The reduced configs the other family tests use have head dims of 16; here
the widths stay narrow (d_model 64, 2 layers, fp32) but the attention's
head dims are the published ones: minicpm3's q and k 64 nope + 32 rope
dims and v 64, so (D, Dv) = (96, 64) reaches the flash forward and
backward; phi-3's head_dim 96, (96, 96).  On the card those calls go to
the fp32 Hopper kernels (``head_dims`` takes both pairs in fp32); on the
CPU they take the plain versions and count no launch, which the last test
asserts.

Both packages start from the JAX package's ``api.init(PRNGKey(0))``
parameters through ``params_from_jax``.  The JAX side runs on its XLA
backend and on its Pallas kernels in interpret mode.  Held: prefill
logits (phi-3's with patch embeddings before the text) and 4
teacher-forced decode steps within 2e-3 (the reference's serve-consistency
tolerance), ``train_loss`` within 2e-4, and one training step's gradients
(``loss_and_grads``, through the flash kernels' autograd rule) against
``jax.grad`` within 1e-3, the JAX gradients mapped onto the port's
parameters by ``params_from_jax`` itself.
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
from repro_torch import kernels
from repro_torch.interop import params_from_jax
from repro_torch.kernels import head_dims
from repro_torch.models import build as tbuild
from repro_torch.runtime.train_loop import loss_and_grads


@pytest.fixture(autouse=True)
def _torch_threads():
    """One intra-op thread for each test of this file, the previous count
    afterwards, as in the other tight-tolerance port tests."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ARCHS = ["minicpm3_4b", "phi3_vision_4p2b"]
# the published head dims, on the reduced configs' narrow widths
HEAD_DIMS = {"minicpm3_4b": dict(qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
             "phi3_vision_4p2b": dict(head_dim=96)}
TOL, LOSS_TOL, GRAD_TOL = 2e-3, 2e-4, 1e-3
B, T = 2, 12

_MODELS: dict = {}


def _models(arch):
    """(JAX api, JAX params, port api, port model), built once an arch."""
    if arch not in _MODELS:
        cfg_j = jcfgs.reduced(jcfgs.get(arch)).replace(**HEAD_DIMS[arch])
        cfg_t = tcfgs.reduced(tcfgs.get(arch)).replace(**HEAD_DIMS[arch])
        api_j, api_t = jbuild(cfg_j), tbuild(cfg_t)
        params = api_j.init(jax.random.PRNGKey(0))
        model = params_from_jax(jax.tree.map(np.asarray, params), cfg_t, "cpu")
        _MODELS[arch] = (api_j, params, api_t, model)
    return _MODELS[arch]


def _flash_dims(cfg):
    """(D, Dv) of the config's flash calls."""
    if cfg.attention == "mla":
        return cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim
    return cfg.head_dim, cfg.head_dim


def _backend(name):
    return (jkernels.backend("pallas", interpret=True) if name == "pallas"
            else contextlib.nullcontext())


def _extra(cfg, seed):
    """phi-3's patch embeddings before the text; nothing for minicpm3."""
    if cfg.frontend != "vision":
        return {}
    return {"patch_embeds": np.random.default_rng(seed).standard_normal(
        (B, cfg.n_patch_tokens, cfg.d_model), np.float32)}


@pytest.mark.parametrize("arch", ARCHS)
def test_head_dims_are_the_published_ones_and_the_fp32_kernels_take_them(arch):
    full = tcfgs.get(arch)
    cfg = _models(arch)[2].cfg
    assert _flash_dims(cfg) == _flash_dims(full) == {"minicpm3_4b": (96, 64),
                                                    "phi3_vision_4p2b": (96, 96)}[arch]
    assert cfg.compute_dtype == cfg.param_dtype == "float32" and cfg.n_layers == 2
    for kind in ("flash_fwd", "flash_bwd"):
        assert head_dims.takes(kind, torch.float32, *_flash_dims(cfg))


@pytest.mark.parametrize("jax_backend", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(arch, jax_backend):
    api_j, params, api_t, model = _models(arch)
    cfg = api_t.cfg
    extra = _extra(cfg, 4)
    P = next(iter(extra.values())).shape[1] if extra else 0
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, T + 4))
    budget = P + T + 8
    with _backend(jax_backend):
        lg_j, caches_j = api_j.prefill(
            params, {"tokens": jnp.asarray(tokens[:, :T]),
                     **{k: jnp.asarray(v) for k, v in extra.items()}}, seq_budget=budget)
        lg_t, caches_t = api_t.prefill(
            model, {"tokens": torch.from_numpy(tokens[:, :T]),
                    **{k: torch.from_numpy(v) for k, v in extra.items()}}, seq_budget=budget)
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=TOL, rtol=TOL,
                                   err_msg=f"{arch} prefill")
        for i in range(4):
            step = tokens[:, T + i:T + i + 1]
            lg_j, caches_j = api_j.decode(
                params, {"tokens": jnp.asarray(step, jnp.int32),
                         "cache_index": jnp.asarray(P + T + i, jnp.int32)}, caches_j)
            lg_t, caches_t = api_t.decode(
                model, {"tokens": torch.from_numpy(step), "cache_index": P + T + i},
                caches_t)
            np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=TOL,
                                       rtol=TOL, err_msg=f"{arch} decode step {i}")


@pytest.mark.parametrize("jax_backend", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, jax_backend):
    api_j, params, api_t, model = _models(arch)
    cfg = api_t.cfg
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, 16)),
             "targets": rng.integers(0, cfg.vocab_size, (B, 16)), **_extra(cfg, 8)}
    with _backend(jax_backend):
        (loss_j, _), grads_j = jax.value_and_grad(
            lambda p: api_j.train_loss(p, {k: jnp.asarray(v) for k, v in batch.items()}),
            has_aux=True)(params)
    model.requires_grad_(True)
    try:
        loss_t, _, grads_t = loss_and_grads(
            api_t, model, {k: torch.from_numpy(v) for k, v in batch.items()})
    finally:
        model.requires_grad_(False)
    np.testing.assert_allclose(float(loss_t), float(loss_j), atol=LOSS_TOL, rtol=LOSS_TOL)
    ref = dict(params_from_jax(jax.tree.map(np.asarray, grads_j), cfg, "cpu")
               .named_parameters())
    assert ref.keys() == grads_t.keys()
    for name, g in grads_t.items():
        assert g.shape == ref[name].shape, name
        np.testing.assert_allclose(g.numpy(), ref[name].detach().numpy(), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=f"{arch} {name}")
    assert all(float(g.abs().max()) > 0 for g in grads_t.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_cpu_fp32_calls_take_the_plain_versions_and_count_no_launch(arch):
    """Prefill, decode and a training step of the fp32 model on the CPU go
    through the plain versions: no kernel counts a launch and no library
    is loaded."""
    _, _, api_t, model = _models(arch)
    cfg = api_t.cfg
    before = [kern.launches for kern in kernels.KERNELS]
    loaded = [kern._fn is not None for kern in kernels.KERNELS]
    rng = np.random.default_rng(11)
    extra = {k: torch.from_numpy(v) for k, v in _extra(cfg, 12).items()}
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T + 1)))
    P = next(iter(extra.values())).shape[1] if extra else 0
    lg, caches = api_t.prefill(model, {"tokens": tokens[:, :T], **extra},
                               seq_budget=P + T + 1)
    lg, _ = api_t.decode(model, {"tokens": tokens[:, T:], "cache_index": P + T}, caches)
    assert lg.dtype == torch.float32 and torch.isfinite(lg).all()
    model.requires_grad_(True)
    try:
        loss, _, _ = loss_and_grads(api_t, model, {"tokens": tokens[:, :T],
                                                   "targets": tokens[:, 1:], **extra})
    finally:
        model.requires_grad_(False)
    assert torch.isfinite(loss)
    assert [kern.launches for kern in kernels.KERNELS] == before
    assert [kern._fn is not None for kern in kernels.KERNELS] == loaded
