"""Reduced whisper-tiny (the encoder-decoder) trained on a mesh of spawned
gloo ranks, against the JAX package's unsharded model.

The weights come from the reference's ``api.init(PRNGKey(0))`` through
``params_from_jax``; each rank distributes them by their train specs
(``distribute_model``) on a ("data", "model") = (2, 2) mesh of 4 CPU
ranks.  The encoder's non-causal attention, the decoder's causal
self-attention and its cross-attention over the encoder output run
through ``local_map`` over "model" (4 heads, 2 a rank), the batch over
"data".
- ``loss_and_grads`` under the mesh and two ``make_train_step(axes=...)``
  steps against the reference's: the losses within 2e-4, the gradients
  and the parameters after the steps within 1e-3, ``grad_norm`` within
  1e-5 relative, and each step's change of every weight within 1e-3 of
  the reference's in relative norm.
- On a one-rank mesh, the loss, every gradient, every step's loss and
  grad_norm and every weight after the steps bit-identical to the same
  without a mesh.
- ``merge_heads``' backward hands the merge a gradient of whole heads: 6
  heads of 8 merged on a ("data", "model") = (1, 4) mesh, a gradient
  sharded 4 ways over the merged dim (12 columns a rank, through a head),
  comes back as the split gradient, every value in place (whisper-tiny's
  6 heads over 16 ranks are such a cut).
"""

from functools import partial

import numpy as np
import pytest
import torch

import repro_torch.configs as tcfgs
from repro_torch.interop import params_from_jax
from repro_torch.models import build as tbuild
from test_torch_tp_attention import run_world

ARCH = "whisper_tiny"
AXES = ("data", "model")
B, S = 2, 16
LOSS_TOL, GRAD_TOL, NORM_TOL, DELTA_TOL = 2e-4, 1e-3, 1e-5, 1e-3
LR = 3e-4
TRAIN_SEEDS = (4, 5)  # the two steps' batches


@pytest.fixture(autouse=True)
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "enc_frames": rng.standard_normal((B, cfg.encoder_seq_len, cfg.d_model),
                                              np.float32)}


def _train_config():
    from repro_torch.runtime.train_loop import TrainConfig

    return TrainConfig(lr=LR, warmup_steps=0, total_steps=10)


def _train_world(np_params, rank, world, shape=(2, 2), compare_unsharded=False):
    """One rank: the loss and gradients of the first batch, then two
    training steps, on ``shape``'s mesh; with ``compare_unsharded`` also
    without a mesh, and only whether each result is bit-identical comes
    back."""
    from torch.distributed.tensor import DTensor

    from repro_torch.runtime.elastic import make_elastic_mesh
    from repro_torch.runtime.train_loop import loss_and_grads, make_train_state, make_train_step
    from repro_torch.sharding.hints import mesh_axes, use_mesh
    from repro_torch.sharding.specs import distribute_batch, distribute_model

    def full(t):  # a copy: the optimizer updates the weights in place
        return (t.full_tensor() if isinstance(t, DTensor) else t).detach().clone()

    cfg = tcfgs.reduced(tcfgs.get(ARCH))
    api, tc = tbuild(cfg), _train_config()
    mesh = make_elastic_mesh(shape, device_type="cpu")
    batches = [{k: torch.from_numpy(v) for k, v in _batch(cfg, seed).items()}
               for seed in TRAIN_SEEDS]

    def run(mesh_on):
        params = params_from_jax(np_params, cfg, "cpu")
        state = make_train_state(api, tc, params=distribute_model(params, mesh)
                                 if mesh_on else params)
        with use_mesh(mesh if mesh_on else None), mesh_axes(AXES if mesh_on else None):
            loss, _, grads = loss_and_grads(
                api, state["params"], distribute_batch(batches[0], mesh) if mesh_on
                else batches[0])
        step = make_train_step(api, tc, axes=AXES if mesh_on else None)
        weights = [{k: full(p) for k, p in state["params"].named_parameters()}]
        metrics = []
        for b in batches:
            state, m = step(state, b)
            weights.append({k: full(p) for k, p in state["params"].named_parameters()})
            metrics.append(m)
        return {"loss": full(loss), "grads": {k: full(g) for k, g in grads.items()},
                "params": weights[-1],
                "deltas": [{k: w1[k] - w0[k] for k in w0} for w0, w1 in zip(weights, weights[1:])],
                "step_loss": torch.stack([full(m["loss"]) for m in metrics]),
                "grad_norm": torch.stack([full(m["grad_norm"]) for m in metrics]),
                "placed": str(state["params"].encoder[0].attn.wq.placements) if mesh_on else ""}

    got = run(True)
    if not compare_unsharded:
        return {k: ({n: t.numpy() for n, t in v.items()} if isinstance(v, dict)
                    else [{n: t.numpy() for n, t in d.items()} for d in v] if isinstance(v, list)
                    else v.numpy() if isinstance(v, torch.Tensor) else v)
                for k, v in got.items()}
    ref = run(False)

    def same(a, b):
        return all(torch.equal(a[k], b[k]) for k in b)

    return {"loss": torch.equal(got["loss"], ref["loss"]),
            "grads": same(got["grads"], ref["grads"]),
            "params": all(same(a, b) for a, b in zip(got["deltas"], ref["deltas"]))
            and same(got["params"], ref["params"]),
            "step_loss": torch.equal(got["step_loss"], ref["step_loss"])
            and torch.equal(got["grad_norm"], ref["grad_norm"])}


@pytest.fixture(scope="module")
def reference():
    """The reference's weights (numpy), loss, gradients and two steps."""
    import jax
    import jax.numpy as jnp

    import repro.configs as jcfgs
    from repro.models import build as jbuild
    from repro.optim.adamw import init_opt_state
    from repro.runtime.train_loop import TrainConfig, make_train_step

    cfg = jcfgs.reduced(jcfgs.get(ARCH))
    api = jbuild(cfg)
    params = api.init(jax.random.PRNGKey(0))
    batches = [{k: jnp.asarray(v) for k, v in _batch(cfg, seed).items()}
               for seed in TRAIN_SEEDS]
    (loss, _), grads = jax.value_and_grad(lambda p: api.train_loss(p, batches[0]),
                                          has_aux=True)(params)
    tc = TrainConfig(lr=LR, warmup_steps=0, total_steps=10)
    state = {"params": params, "opt": init_opt_state(params, moment_dtype=cfg.opt_state_dtype)}
    step = make_train_step(api, tc)
    tcfg = tcfgs.reduced(tcfgs.get(ARCH))

    def named(tree):
        return {k: v.detach().numpy() for k, v in params_from_jax(
            jax.tree.map(np.asarray, tree), tcfg, "cpu").named_parameters()}

    weights, metrics = [named(params)], []
    for b in batches:
        state, m = step(state, b)
        weights.append(named(state["params"]))
        metrics.append(m)
    return {"np_params": jax.tree.map(np.asarray, params), "loss": float(loss),
            "grads": named(grads), "params": weights[-1],
            "deltas": [{k: w1[k] - w0[k] for k in w0} for w0, w1 in zip(weights, weights[1:])],
            "step_loss": np.array([float(m["loss"]) for m in metrics]),
            "grad_norm": np.array([float(m["grad_norm"]) for m in metrics])}


@pytest.fixture(scope="module")
def mesh_2x2(reference, tmp_path_factory):
    return run_world(partial(_train_world, reference["np_params"]), 4,
                     tmp_path_factory.mktemp("encdec2x2"))


def test_sharded_encdec_train_step_matches_the_reference(reference, mesh_2x2):
    for rank, res in mesh_2x2.items():
        assert res["placed"] == "(Shard(dim=0), Shard(dim=1))"  # wq: d over data, heads over model
        for key in ("loss", "step_loss"):
            np.testing.assert_allclose(res[key], reference[key], atol=LOSS_TOL, rtol=LOSS_TOL,
                                       err_msg=f"rank {rank} {key}")
        np.testing.assert_allclose(res["grad_norm"], reference["grad_norm"], rtol=NORM_TOL,
                                   err_msg=f"rank {rank} grad_norm")
        for part in ("grads", "params"):
            assert res[part].keys() == reference[part].keys()
            for name, got in res[part].items():
                np.testing.assert_allclose(got, reference[part][name], atol=GRAD_TOL,
                                           rtol=GRAD_TOL, err_msg=f"rank {rank} {part} {name}")


def test_sharded_encdec_steps_move_the_weights_as_the_reference(reference, mesh_2x2):
    for rank, res in mesh_2x2.items():
        for i, (got, want) in enumerate(zip(res["deltas"], reference["deltas"])):
            assert got.keys() == want.keys()
            for name, d in got.items():
                ref = want[name]
                rel = np.linalg.norm(d - ref) / max(np.linalg.norm(ref), 1e-30)
                assert rel <= DELTA_TOL, (rank, f"step {i + 1}", name, rel)


def test_a_one_rank_encdec_mesh_is_bit_identical_to_no_mesh(reference, tmp_path):
    res = run_world(partial(_train_world, reference["np_params"], shape=(1, 1),
                            compare_unsharded=True), 1, tmp_path)
    assert res == {0: {"loss": True, "grads": True, "params": True, "step_loss": True}}


def _merge_world(rank, world):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.runtime.elastic import make_elastic_mesh
    from repro_torch.sharding.hints import merge_heads

    mesh = make_elastic_mesh((1, 4), device_type="cpu")
    full = torch.arange(2 * 3 * 6 * 8, dtype=torch.float32).reshape(2, 3, 6, 8)
    x = distribute_tensor(full, mesh, [Replicate(), Replicate()]).requires_grad_(True)
    merged = merge_heads(x)
    g = distribute_tensor(full.reshape(2, 3, 48) * 2, mesh, [Replicate(), Shard(2)])
    (gx,) = torch.autograd.grad(merged, x, g)
    return {"merged": tuple(merged.shape), "grad": torch.equal(gx.full_tensor(), full * 2),
            "placed": str(list(gx.placements))}


def test_merge_heads_gives_the_split_whole_heads(tmp_path):
    res = run_world(_merge_world, 4, tmp_path)
    assert all(r == {"merged": (2, 3, 48), "grad": True,
                     "placed": "[Replicate(), Replicate()]"} for r in res.values()), res
