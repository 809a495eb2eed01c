"""Reduced llama3.2-1B distributed on a mesh of spawned gloo ranks, against
the JAX package's unsharded model.

The weights come from the reference's ``api.init(PRNGKey(0))`` through
``params_from_jax``; each rank distributes them by their specs
(``distribute_model``: serve specs for serving, train specs for
training) on a ("data", "model") = (2, 2) mesh of 4 CPU ranks, and runs
under ``use_mesh`` and ``mesh_axes``: the attention through
``local_map`` over "model", the batch over "data".
- Prefill logits and 4 teacher-forced decode steps within 2e-3 of the
  reference's; prefill leaves the KV caches laid out by
  ``cache_partition_specs`` (the sequence over "model") and the decode
  steps leave them so.
- Two ``make_train_step(axes=...)`` steps against the reference's
  ``make_train_step`` on two batches: the losses within 2e-4, the
  gradients (``loss_and_grads`` under the mesh) and the parameters after
  the steps within 1e-3, ``grad_norm`` within 1e-5 relative, and each
  step's change of every weight within 1e-3 of the reference's change in
  relative norm (a step that moves nothing, or moves a weight the wrong
  way, is 1 or more off; the first AdamW step moves a weight by about lr,
  3e-4, so the elementwise check alone cannot see one).  The second step
  runs on the first's moments, with the gradients clipped (clip_norm 1);
  no warmup, so that the first step moves the weights (a warmup's first
  learning rate is 0).
- On a one-rank mesh, every logit, the losses, every gradient, every
  grad_norm and every weight after each step bit-identical to the same
  without a mesh.
"""

from functools import partial

import numpy as np
import pytest
import torch

import repro_torch.configs as tcfgs
from repro_torch.interop import params_from_jax
from repro_torch.models import build as tbuild
from test_torch_tp_attention import run_world

ARCH = "llama3p2_1b"
AXES = ("data", "model")
B, PROMPT, STEPS = 2, 12, 4
TOL, LOSS_TOL, GRAD_TOL, NORM_TOL, DELTA_TOL = 2e-3, 2e-4, 1e-3, 1e-5, 1e-3
LR = 3e-4


@pytest.fixture(autouse=True)
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tokens(cfg):
    return np.random.default_rng(3).integers(0, cfg.vocab_size, (B, PROMPT + STEPS)).astype(
        np.int32)


def _batch(cfg, seed=4):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, 16)).astype(np.int32),
            "targets": rng.integers(0, cfg.vocab_size, (B, 16)).astype(np.int32)}


TRAIN_SEEDS = (4, 5)  # the two steps' batches


def _train_config():
    from repro_torch.runtime.train_loop import TrainConfig

    return TrainConfig(lr=LR, warmup_steps=0, total_steps=10)


def _placed(caches):
    """Each layer's KV caches' placements (empty for plain tensors)."""
    return [[str(getattr(c[n], "placements", "")) for n in ("k", "v")] for c in caches]


def _serve(api, model, tokens):
    """Logits of prefill and each decode step, and the caches' placements
    after prefill and after each step."""
    logits, caches = api.prefill(model, {"tokens": tokens[:, :PROMPT]},
                                 seq_budget=PROMPT + STEPS)
    out, placed = [logits], [_placed(caches)]
    for i in range(STEPS):
        logits, caches = api.decode(model, {"tokens": tokens[:, PROMPT + i:PROMPT + i + 1],
                                            "cache_index": PROMPT + i}, caches)
        out.append(logits)
        placed.append(_placed(caches))
    return out, placed


def _model_world(np_params, rank, world, shape=(2, 2), compare_unsharded=False):
    """One rank: serve and two training steps on ``shape``'s mesh; with
    ``compare_unsharded`` also without a mesh, and only whether each
    result is bit-identical comes back."""
    from torch.distributed.tensor import DTensor

    from repro_torch.runtime.elastic import make_elastic_mesh
    from repro_torch.runtime.train_loop import loss_and_grads, make_train_state, make_train_step
    from repro_torch.sharding.hints import mesh_axes, use_mesh
    from repro_torch.sharding.specs import (cache_partition_specs, distribute_batch,
                                            distribute_model, mesh_sizes, placements)

    def full(t):  # a copy: the optimizer updates the weights in place
        return (t.full_tensor() if isinstance(t, DTensor) else t).detach().clone()

    cfg = tcfgs.reduced(tcfgs.get(ARCH))
    api, tc = tbuild(cfg), _train_config()
    mesh = make_elastic_mesh(shape, device_type="cpu")
    tokens = torch.from_numpy(_tokens(cfg))
    batches = [{k: torch.from_numpy(v) for k, v in _batch(cfg, seed).items()}
               for seed in TRAIN_SEEDS]
    batch = batches[0]

    def fresh():
        return params_from_jax(np_params, cfg, "cpu")

    def run(mesh_on):
        model = distribute_model(fresh(), mesh, mode="serve") if mesh_on else fresh()
        with use_mesh(mesh if mesh_on else None), mesh_axes(AXES if mesh_on else None):
            to = partial(distribute_batch, mesh=mesh) if mesh_on else (lambda b: b)
            logits, placed = _serve(api, model, to({"t": tokens})["t"])
            logits = [full(x) for x in logits]
        params = distribute_model(fresh(), mesh) if mesh_on else fresh()
        state = make_train_state(api, tc, params=params)
        with use_mesh(mesh if mesh_on else None), mesh_axes(AXES if mesh_on else None):
            loss, _, grads = loss_and_grads(api, state["params"],
                                            distribute_batch(batch, mesh) if mesh_on else batch)
        step = make_train_step(api, tc, axes=AXES if mesh_on else None)
        weights = [{k: full(p) for k, p in state["params"].named_parameters()}]
        metrics = []
        for b in batches:
            state, m = step(state, b)
            weights.append({k: full(p) for k, p in state["params"].named_parameters()})
            metrics.append(m)
        return {"logits": logits, "loss": full(loss),
                "grads": {k: full(g) for k, g in grads.items()},
                "params": weights[-1],
                "deltas": [{k: w1[k] - w0[k] for k in w0} for w0, w1 in zip(weights, weights[1:])],
                "step_loss": torch.stack([full(m["loss"]) for m in metrics]),
                "grad_norm": torch.stack([full(m["grad_norm"]) for m in metrics]),
                "placed": str(state["params"].blocks[0].attn.wq.placements) if mesh_on else "",
                "caches": placed}

    def cache_placements():
        """What cache_partition_specs lays a KV cache out as on the mesh."""
        kv = torch.zeros(B, PROMPT + STEPS, cfg.n_kv_heads, cfg.head_dim)
        spec = cache_partition_specs([{"k": kv}], AXES, global_batch=B,
                                     dp_size=mesh_sizes(mesh)["data"],
                                     axis_sizes=mesh_sizes(mesh))[0]["k"]
        return str(placements(spec, mesh)).replace("[", "(").replace("]", ")")

    def as_numpy(v):
        if isinstance(v, torch.Tensor):
            return v.numpy()
        if isinstance(v, dict):
            return {n: as_numpy(x) for n, x in v.items()}
        if isinstance(v, list):
            return [as_numpy(x) for x in v]
        return v

    got = run(True)
    if not compare_unsharded:
        return {**as_numpy(got), "cache_placements": cache_placements()}
    ref = run(False)

    def same(a, b):
        return all(torch.equal(a[k], b[k]) for k in b)

    return {"logits": all(torch.equal(a, b) for a, b in zip(got["logits"], ref["logits"])),
            "loss": torch.equal(got["loss"], ref["loss"]),
            "grads": same(got["grads"], ref["grads"]),
            "params": all(same(a, b) for a, b in zip(got["deltas"], ref["deltas"]))
            and same(got["params"], ref["params"]),
            "step_loss": torch.equal(got["step_loss"], ref["step_loss"])
            and torch.equal(got["grad_norm"], ref["grad_norm"])}


@pytest.fixture(scope="module")
def reference():
    """The reference's weights (numpy), outputs, gradients and one step."""
    import jax
    import jax.numpy as jnp

    import repro.configs as jcfgs
    from repro.models import build as jbuild
    from repro.optim.adamw import init_opt_state
    from repro.runtime.train_loop import TrainConfig, make_train_step

    cfg = jcfgs.reduced(jcfgs.get(ARCH))
    api = jbuild(cfg)
    params = api.init(jax.random.PRNGKey(0))
    tokens = _tokens(cfg)
    logits, caches = api.prefill(params, {"tokens": jnp.asarray(tokens[:, :PROMPT])},
                                 seq_budget=PROMPT + STEPS)
    out = [np.asarray(logits)]
    for i in range(STEPS):
        logits, caches = api.decode(params, {
            "tokens": jnp.asarray(tokens[:, PROMPT + i:PROMPT + i + 1]),
            "cache_index": jnp.asarray(PROMPT + i, jnp.int32)}, caches)
        out.append(np.asarray(logits))
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
    return {"np_params": jax.tree.map(np.asarray, params), "logits": out,
            "loss": float(loss), "grads": named(grads), "params": weights[-1],
            "deltas": [{k: w1[k] - w0[k] for k in w0} for w0, w1 in zip(weights, weights[1:])],
            "step_loss": np.array([float(m["loss"]) for m in metrics]),
            "grad_norm": np.array([float(m["grad_norm"]) for m in metrics])}


@pytest.fixture(scope="module")
def mesh_2x2(reference, tmp_path_factory):
    return run_world(partial(_model_world, reference["np_params"]), 4,
                     tmp_path_factory.mktemp("mesh2x2"))


def test_sharded_serving_matches_the_reference(reference, mesh_2x2):
    for rank, res in mesh_2x2.items():
        assert res["placed"] == "(Shard(dim=0), Shard(dim=1))"
        want = res["cache_placements"]
        assert want == "(Shard(dim=0), Shard(dim=1))"  # batch over data, sequence over model
        for i, layers in enumerate(res["caches"]):
            assert all(p == want for layer in layers for p in layer), (rank, i, layers)
        for i, (got, want) in enumerate(zip(res["logits"], reference["logits"])):
            np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL,
                                       err_msg=f"rank {rank}, {'prefill' if i == 0 else i}")


def test_sharded_train_step_matches_the_reference(reference, mesh_2x2):
    for rank, res in mesh_2x2.items():
        for key in ("loss", "step_loss"):
            np.testing.assert_allclose(res[key], reference[key], atol=LOSS_TOL,
                                       rtol=LOSS_TOL, err_msg=f"rank {rank} {key}")
        np.testing.assert_allclose(res["grad_norm"], reference["grad_norm"], rtol=NORM_TOL,
                                   err_msg=f"rank {rank} grad_norm")
        for part in ("grads", "params"):
            assert res[part].keys() == reference[part].keys()
            for name, got in res[part].items():
                np.testing.assert_allclose(got, reference[part][name], atol=GRAD_TOL,
                                           rtol=GRAD_TOL, err_msg=f"rank {rank} {part} {name}")


def test_a_one_rank_mesh_is_bit_identical_to_no_mesh(reference, tmp_path):
    res = run_world(partial(_model_world, reference["np_params"], shape=(1, 1),
                            compare_unsharded=True), 1, tmp_path)
    assert res == {0: {"logits": True, "loss": True, "grads": True, "params": True,
                       "step_loss": True}}


def test_sharded_train_steps_move_the_weights_as_the_reference(reference, mesh_2x2):
    assert (reference["grad_norm"] > 1.0).all()  # both steps clip
    for rank, res in mesh_2x2.items():
        for i, (got, want) in enumerate(zip(res["deltas"], reference["deltas"])):
            assert got.keys() == want.keys()
            for name, d in got.items():
                ref = want[name]
                rel = np.linalg.norm(d - ref) / np.linalg.norm(ref)
                assert rel <= DELTA_TOL, (rank, f"step {i + 1}", name, rel)
