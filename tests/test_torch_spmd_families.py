"""The Mamba, MoE and hybrid families distributed on a mesh of spawned gloo
ranks, and the vocabulary-parallel loss, against the JAX package's
unsharded models.

The weights come from the reference's ``api.init(PRNGKey(0))`` through
``params_from_jax``; each rank distributes them by their specs
(``distribute_model``: serve specs for serving, train specs for
training) on a ("data", "model") = (2, 2) mesh of 4 CPU ranks and runs
under ``use_mesh`` and ``mesh_axes``.  One world runs every family:
- reduced falcon-mamba (the scan under ``local_map`` on each rank's
  d_inner shard), llama4-maverick and arctic (the experts under one
  expert-parallel ``local_map``; arctic with int8 moments, whose reduced
  shards cut a 256-element block), served and trained; reduced jamba
  (Mamba, attention and MoE layers) served.  Prefill logits and 4
  teacher-forced decode steps within 2e-3 of the reference's; the loss
  and gradients of one batch (``loss_and_grads`` under the mesh) and two
  ``make_train_step(axes=...)`` steps: the losses within 2e-4, the
  gradients and the weights after the steps within 1e-3, ``grad_norm``
  within 1e-5 relative, and each step's change of every weight within
  1e-3 of the reference's change in relative norm (the first AdamW step
  moves a weight by about lr, 3e-4, below the elementwise check; the
  second step is the first to read the moments back).  With int8
  moments (arctic) the changes, and the moments decoded after each step,
  within 5e-3 in relative norm (``INT8_TOL``): a step that moves nothing,
  a shard's update not written back, or moments quantized in a shard's
  blocks instead of the whole last dim's, is 2e-2 to 1 off.
- each rank's layers run on its own shards: the scan on d_inner / 2
  channels, the experts on E / 2, the loss over V / 2 of the vocabulary;
  the int8 moments laid out as ``opt_state_partition_specs`` (the
  reference's sanitized moment specs) puts them.
- ``token_nll`` on a mesh against the reference's at 2e-4 for the loss and
  1e-3 for the gradients, with a vocabulary of 512 (split over "model")
  and of 511 (which "model" does not divide: each rank takes the whole
  table).
On a one-rank mesh, every one of these results is bit-identical to the
same run without a mesh.  And on a fake 16 x 16 world, arctic's int8
moments are laid out by the reference's specs.
"""

import json
import os
import subprocess
import sys
import textwrap
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.configs as tcfgs
from repro_torch.interop import params_from_jax
from repro_torch.models import build as tbuild
from repro_torch.sharding.specs import P
from test_torch_tp_attention import run_world

AXES = ("data", "model")
B, PROMPT, STEPS = 2, 12, 4
TOL, LOSS_TOL, GRAD_TOL, NORM_TOL, DELTA_TOL = 2e-3, 2e-4, 1e-3, 1e-5, 1e-3
# A step's change and the decoded moments with int8 moments, in relative
# norm: a log-domain code of the second moment flips where 1e-6 of gradient
# noise crosses a rounding boundary, and a code's step is up to ~20% of v
# in a block that holds an expert's zero gradients.  The unsharded port is
# itself 1.1e-3 from the reference's second step on reduced arctic; an
# update that quantizes a shard's blocks is 2e-2 off, its moments 0.5.
INT8_TOL = 5e-3
LR = 3e-4
TRAIN_SEEDS = (4, 5)  # the two steps' batches
# name: (arch, config overrides, trained)
FAMILIES = {"falcon_mamba": ("falcon_mamba_7b", {}, True),
            "llama4": ("llama4_maverick_400b_a17b", {}, True),
            "arctic": ("arctic_480b", {"opt_state_dtype": "int8"}, True),
            "jamba": ("jamba_1p5_large_398b", {}, False)}
TRAINED = [name for name, (_, _, train) in FAMILIES.items() if train]
VOCABS = (512, 511)  # divides "model" = 2, and does not
NLL = dict(B=4, S=24, d=16, chunk=8)
P_ROWS, P_TABLE = P("data"), P("model", "data")  # the batch; the table's train spec


@pytest.fixture(autouse=True)
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg(pkg, name):
    arch, over, _ = FAMILIES[name]
    return pkg.reduced(pkg.get(arch)).replace(**over)


def _tokens(cfg):
    return np.random.default_rng(3).integers(0, cfg.vocab_size, (B, PROMPT + STEPS)).astype(
        np.int32)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, 16)).astype(np.int32),
            "targets": rng.integers(0, cfg.vocab_size, (B, 16)).astype(np.int32)}


def _nll_inputs(V):
    rng = np.random.default_rng(6)
    return (rng.standard_normal((NLL["B"], NLL["S"], NLL["d"])).astype(np.float32),
            (0.5 * rng.standard_normal((V, NLL["d"]))).astype(np.float32),
            rng.integers(0, V, (NLL["B"], NLL["S"])).astype(np.int32))


def _deltas(weights):
    """Each step's change of every weight, from the weights before and
    after each step."""
    return [{k: w1[k] - w0[k] for k in w0} for w0, w1 in zip(weights, weights[1:])]


def _world(np_params, rank, world, shape=(2, 2), compare_unsharded=False):
    """One rank: every family served (and trained) and ``token_nll`` on
    ``shape``'s mesh, with what ran on each rank's shards; with
    ``compare_unsharded`` also without a mesh, and only whether each result
    is bit-identical comes back."""
    from torch.distributed.tensor import DTensor

    import repro_torch.kernels.mamba_scan.sharded as scan_tp
    from repro_torch.models import loss as tloss
    from repro_torch.models.moe import MoE
    from repro_torch.optim import dequantize_blockwise, opt_state_partition_specs
    from repro_torch.runtime.elastic import make_elastic_mesh
    from repro_torch.runtime.train_loop import (TrainConfig, loss_and_grads, make_train_state,
                                                make_train_step)
    from repro_torch.sharding.hints import mesh_axes, use_mesh
    from repro_torch.sharding.specs import (distribute, distribute_batch, distribute_model,
                                            mesh_sizes, placements, tree_partition_specs)

    mesh = make_elastic_mesh(shape, device_type="cpu")
    seen = {"scan d": set(), "experts": set(), "vocab-parallel": 0}
    scan, combined, vocab = scan_tp.mamba_scan, MoE._experts_combined, tloss._VocabNLL.apply

    def scan_spy(x, *a):
        seen["scan d"].add(x.shape[-1])
        return scan(x, *a)

    def experts_spy(self, x, dispatch, *a):
        if not isinstance(dispatch, DTensor):
            seen["experts"].add(dispatch.shape[2])
        return combined(self, x, dispatch, *a)

    def vocab_spy(*a):
        seen["vocab-parallel"] += 1
        return vocab(*a)

    scan_tp.mamba_scan, MoE._experts_combined, tloss._VocabNLL.apply = (
        scan_spy, experts_spy, vocab_spy)

    def full(t):  # a copy: the optimizer updates the weights in place
        return (t.full_tensor() if isinstance(t, DTensor) else t).detach().clone()

    def on(mesh_on):
        return use_mesh(mesh if mesh_on else None), mesh_axes(AXES if mesh_on else None)

    def family(name, mesh_on):
        cfg = _cfg(tcfgs, name)
        api = tbuild(cfg)

        def fresh(mode="train"):
            model = params_from_jax(np_params[name], cfg, "cpu")
            return distribute_model(model, mesh, mode=mode) if mesh_on else model

        tokens = torch.from_numpy(_tokens(cfg))
        model = fresh("serve")
        a, b = on(mesh_on)
        with a, b:
            if mesh_on:
                tokens = distribute_batch({"t": tokens}, mesh)["t"]
            logits, caches = api.prefill(model, {"tokens": tokens[:, :PROMPT]},
                                         seq_budget=PROMPT + STEPS)
            out = {"logits": [full(logits)]}
            for i in range(STEPS):
                logits, caches = api.decode(model, {
                    "tokens": tokens[:, PROMPT + i:PROMPT + i + 1],
                    "cache_index": PROMPT + i}, caches)
                out["logits"].append(full(logits))
        if not FAMILIES[name][2]:
            return out
        tc = TrainConfig(lr=LR, warmup_steps=0, total_steps=10)
        batches = [{k: torch.from_numpy(v) for k, v in _batch(cfg, seed).items()}
                   for seed in TRAIN_SEEDS]
        state = make_train_state(api, tc, params=fresh())
        a, b = on(mesh_on)
        with a, b:
            first = distribute_batch(batches[0], mesh) if mesh_on else batches[0]
            loss, _, grads = loss_and_grads(api, state["params"], first)
        if mesh_on and cfg.opt_state_dtype == "int8":  # the moments' layout
            pspecs = tree_partition_specs(state["params"], AXES, mesh_sizes(mesh))
            want = opt_state_partition_specs(state["opt"], pspecs, AXES, mesh_sizes(mesh))
            out["moments"] = all(
                list(t.placements) == placements(want[part][k][piece], mesh)
                for part in ("m", "v") for k, mom in state["opt"][part].items()
                for piece, t in mom.items())
        step = make_train_step(api, tc, axes=AXES if mesh_on else None)

        def weights():
            return {k: full(p) for k, p in state["params"].named_parameters()}

        def moments():  # int8 moments decoded
            shapes = {k: p.shape for k, p in state["params"].named_parameters()}
            return {part: {k: dequantize_blockwise(
                *(full(mom[j]) for j in ("codes", "scale", "offset")), shapes[k][-1],
                log_domain=part == "v") for k, mom in state["opt"][part].items()}
                for part in ("m", "v")}

        seen_w, seen_m, metrics = [weights()], [], []
        for batch in batches:
            state, m = step(state, batch)
            seen_w.append(weights())
            if cfg.opt_state_dtype == "int8":
                seen_m.append(moments())
            metrics.append(m)
        out.update(loss=full(loss), grads={k: full(g) for k, g in grads.items()},
                   params=seen_w[-1], deltas=_deltas(seen_w), int8_moments=seen_m,
                   step_loss=torch.stack([full(m["loss"]) for m in metrics]),
                   grad_norm=torch.stack([full(m["grad_norm"]) for m in metrics]))
        return out

    def nll(V, mesh_on):
        x, w, t = (torch.from_numpy(a) for a in _nll_inputs(V))
        x, w = x.requires_grad_(), w.requires_grad_()
        a, b = on(mesh_on)
        with a, b:
            if mesh_on:
                xs, ws = distribute(x.detach(), P_ROWS, mesh), distribute(w.detach(), P_TABLE,
                                                                          mesh)
                xs, ws = xs.requires_grad_(), ws.requires_grad_()
                ts = distribute(t, P_ROWS, mesh)
            else:
                xs, ws, ts = x, w, t
            got = tloss.token_nll(xs, ws, ts, NLL["chunk"])
            gx, gw = torch.autograd.grad(got.sum(), (xs, ws))
        return {"nll": full(got), "dx": full(gx), "dtable": full(gw)}

    def run(mesh_on):
        res = {name: family(name, mesh_on) for name in FAMILIES}
        for V in VOCABS:
            before = seen["vocab-parallel"]
            res[f"nll{V}"] = nll(V, mesh_on)
            res[f"nll{V}"]["vocab-parallel"] = seen["vocab-parallel"] > before
        return res

    got = run(True)
    if not compare_unsharded:
        def as_numpy(v):
            if isinstance(v, torch.Tensor):
                return v.numpy()
            if isinstance(v, dict):
                return {n: as_numpy(x) for n, x in v.items()}
            if isinstance(v, list):
                return [as_numpy(x) for x in v]
            return v

        return {**as_numpy(got), "seen": {k: sorted(v) if isinstance(v, set) else v
                                          for k, v in seen.items()}}
    ref = run(False)

    def same(a, b):
        if isinstance(a, dict):
            return all(same(a[k], b[k]) for k in b if k != "vocab-parallel")
        if isinstance(a, list):
            return all(same(x, y) for x, y in zip(a, b))
        return torch.equal(a, b)

    return {k: same(got[k], ref[k]) for k in ref}


def _reference_params():
    """{family: the reference's weights (numpy)}, from ``PRNGKey(0)``."""
    import jax

    import repro.configs as jcfgs
    from repro.models import build as jbuild

    return {name: jax.tree.map(np.asarray, jax.jit(jbuild(_cfg(jcfgs, name)).init)(
        jax.random.PRNGKey(0))) for name in FAMILIES}


def _reference_runs(np_params):
    """The reference's outputs, gradients and two steps of every family on
    ``np_params``, and its ``token_nll`` with its gradients (the steps and
    the gradients jitted)."""
    import jax
    import jax.numpy as jnp

    import repro.configs as jcfgs
    from repro.models import build as jbuild
    from repro.models.loss import token_nll
    from repro.optim.adamw import dequantize_blockwise, init_opt_state
    from repro.runtime.train_loop import TrainConfig, make_train_step

    out = {}
    for name, (_, _, train) in FAMILIES.items():
        cfg = _cfg(jcfgs, name)
        api = jbuild(cfg)
        params = jax.tree.map(jnp.asarray, np_params[name])
        tokens = _tokens(cfg)
        logits, caches = api.prefill(params, {"tokens": jnp.asarray(tokens[:, :PROMPT])},
                                     seq_budget=PROMPT + STEPS)
        res = out[name] = {"logits": [np.asarray(logits)]}
        for i in range(STEPS):
            logits, caches = api.decode(params, {
                "tokens": jnp.asarray(tokens[:, PROMPT + i:PROMPT + i + 1]),
                "cache_index": jnp.asarray(PROMPT + i, jnp.int32)}, caches)
            res["logits"].append(np.asarray(logits))
        if not train:
            continue
        batches = [{k: jnp.asarray(v) for k, v in _batch(cfg, seed).items()}
                   for seed in TRAIN_SEEDS]
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: api.train_loss(p, batches[0]), has_aux=True))(params)
        tc = TrainConfig(lr=LR, warmup_steps=0, total_steps=10)
        state = {"params": params,
                 "opt": init_opt_state(params, moment_dtype=cfg.opt_state_dtype)}
        step = jax.jit(make_train_step(api, tc))
        tcfg = _cfg(tcfgs, name)

        def named(tree):
            return {k: v.detach().numpy() for k, v in params_from_jax(
                jax.tree.map(np.asarray, tree), tcfg, "cpu").named_parameters()}

        def moments(opt):  # int8 moments decoded, named as the port's parameters
            return {part: named(jax.tree.map(
                lambda mom, p, log=part == "v": dequantize_blockwise(
                    mom["codes"], mom["scale"], mom["offset"], p.shape[-1], log_domain=log),
                opt[part], params, is_leaf=lambda x: isinstance(x, dict) and "codes" in x))
                for part in ("m", "v")}

        weights, seen_m, metrics = [named(params)], [], []
        for b in batches:
            state, m = step(state, b)
            weights.append(named(state["params"]))
            if cfg.opt_state_dtype == "int8":
                seen_m.append(moments(state["opt"]))
            metrics.append(m)
        res.update(loss=float(loss), grads=named(grads), params=weights[-1],
                   deltas=_deltas(weights), int8_moments=seen_m,
                   step_loss=np.array([float(m["loss"]) for m in metrics]),
                   grad_norm=np.array([float(m["grad_norm"]) for m in metrics]))
    for V in VOCABS:
        x, w, t = (jnp.asarray(a) for a in _nll_inputs(V))
        nll, vjp = jax.vjp(lambda x_, w_: token_nll(x_, w_, t, NLL["chunk"]), x, w)
        dx, dtable = vjp(jnp.ones_like(nll))
        out[f"nll{V}"] = {"nll": np.asarray(nll), "dx": np.asarray(dx),
                          "dtable": np.asarray(dtable)}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"reference": ..., "mesh_2x2": {rank: results}, "one_rank": {case:
    bit-identical}}: the two worlds run while the reference computes."""
    from concurrent.futures import ThreadPoolExecutor

    np_params = _reference_params()
    with ThreadPoolExecutor(2) as pool:
        mesh = pool.submit(run_world, partial(_world, np_params), 4,
                           tmp_path_factory.mktemp("families2x2"), timeout=600)
        one = pool.submit(run_world, partial(_world, np_params, shape=(1, 1),
                                             compare_unsharded=True), 1,
                          tmp_path_factory.mktemp("one_rank"), timeout=600)
        reference = _reference_runs(np_params)
        return {"reference": reference, "mesh_2x2": mesh.result(), "one_rank": one.result()[0]}


@pytest.fixture(scope="module")
def reference(runs):
    return runs["reference"]


@pytest.fixture(scope="module")
def mesh_2x2(runs):
    return runs["mesh_2x2"]


@pytest.mark.parametrize("name", list(FAMILIES))
def test_sharded_family_serving_matches_the_reference(reference, mesh_2x2, name):
    for rank, res in mesh_2x2.items():
        for i, (got, want) in enumerate(zip(res[name]["logits"], reference[name]["logits"])):
            np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL,
                                       err_msg=f"rank {rank}, {name}, "
                                               f"{'prefill' if i == 0 else i}")


@pytest.mark.parametrize("name", TRAINED)
def test_sharded_family_train_steps_match_the_reference(reference, mesh_2x2, name):
    want = reference[name]
    for rank, res in mesh_2x2.items():
        got = res[name]
        for key in ("loss", "step_loss"):
            np.testing.assert_allclose(got[key], want[key], atol=LOSS_TOL, rtol=LOSS_TOL,
                                       err_msg=f"rank {rank} {name} {key}")
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=NORM_TOL,
                                   err_msg=f"rank {rank} {name} grad_norm")
        for part in ("grads", "params"):
            assert got[part].keys() == want[part].keys()
            for k, g in got[part].items():
                np.testing.assert_allclose(g, want[part][k], atol=GRAD_TOL, rtol=GRAD_TOL,
                                           err_msg=f"rank {rank} {name} {part} {k}")


@pytest.mark.parametrize("V", VOCABS)
def test_vocab_parallel_token_nll_matches_the_reference(reference, mesh_2x2, V):
    want = reference[f"nll{V}"]
    for rank, res in mesh_2x2.items():
        got = res[f"nll{V}"]
        # split over "model" where it divides the vocabulary, else the whole table
        assert got["vocab-parallel"] == (V % 2 == 0), (rank, V)
        np.testing.assert_allclose(got["nll"], want["nll"], atol=LOSS_TOL, rtol=LOSS_TOL,
                                   err_msg=f"rank {rank} nll")
        for key in ("dx", "dtable"):
            np.testing.assert_allclose(got[key], want[key], atol=GRAD_TOL, rtol=GRAD_TOL,
                                       err_msg=f"rank {rank} {key}")


def test_each_rank_runs_its_own_shards(mesh_2x2):
    d_inner = tcfgs.reduced(tcfgs.get("falcon_mamba_7b")).d_inner
    experts = tcfgs.reduced(tcfgs.get("arctic_480b")).moe.n_experts
    for rank, res in mesh_2x2.items():
        # the scan on d_inner / 2 channels (falcon-mamba's and jamba's), the
        # experts on E / 2, the loss vocabulary-parallel, int8 moments where
        # the reference's specs put them
        assert res["seen"]["scan d"] == [d_inner // 2], (rank, res["seen"])
        assert res["seen"]["experts"] == [experts // 2], (rank, res["seen"])
        assert res["seen"]["vocab-parallel"] > 0
        assert res["arctic"]["moments"] is True


@pytest.mark.parametrize("case", list(FAMILIES) + [f"nll{V}" for V in VOCABS])
def test_a_one_rank_mesh_is_bit_identical_to_no_mesh(runs, case):
    assert runs["one_rank"][case] is True


@pytest.mark.parametrize("name", TRAINED)
def test_sharded_family_train_steps_move_the_weights_as_the_reference(reference, mesh_2x2,
                                                                       name):
    want = reference[name]["deltas"]
    tol = INT8_TOL if FAMILIES[name][1].get("opt_state_dtype") == "int8" else DELTA_TOL
    for rank, res in mesh_2x2.items():
        for i, (got, ref) in enumerate(zip(res[name]["deltas"], want)):
            assert got.keys() == ref.keys()
            for k, d in got.items():
                err, size = np.linalg.norm(d - ref[k]), np.linalg.norm(ref[k])
                assert err <= tol * size, (rank, name, f"step {i + 1}", k, err / size)


def test_sharded_int8_moments_are_the_references_after_each_step(reference, mesh_2x2):
    want = reference["arctic"]["int8_moments"]
    assert len(want) == len(TRAIN_SEEDS)
    for rank, res in mesh_2x2.items():
        for i, (got, ref) in enumerate(zip(res["arctic"]["int8_moments"], want)):
            for part in ("m", "v"):
                assert got[part].keys() == ref[part].keys()
                for k, mom in got[part].items():
                    err, size = np.linalg.norm(mom - ref[part][k]), np.linalg.norm(ref[part][k])
                    assert err <= INT8_TOL * size, (rank, f"step {i + 1}", part, k, err / size)


PRODUCTION_MOMENTS = """
import json
from repro_torch.launch.dryrun import build_step, fake_world
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim import opt_state_partition_specs
from repro_torch.sharding.specs import mesh_sizes, placements, tree_partition_specs
axes = ("data", "model")
with fake_world(256):
    mesh = make_mesh((16, 16), axes, device_type="cpu")
    state = build_step("arctic_480b", "train_4k", mesh, train_overrides={"n_layers": 1},
                       device="cpu").args[0]
    sizes = mesh_sizes(mesh)
    want = opt_state_partition_specs(
        state["opt"], tree_partition_specs(state["params"], axes, sizes), axes, sizes)
    out = {f"{part} {k} {piece}": [str(list(t.placements)),
                                   str(placements(want[part][k][piece], mesh))]
           for part in ("m", "v") for k, mom in state["opt"][part].items()
           for piece, t in mom.items()}
print("RESULT" + json.dumps(out))
"""


def test_int8_moments_take_the_references_specs_on_the_production_mesh():
    """arctic at 1 layer on fake tensors over a fake 16 x 16 world: every
    int8 moment piece laid out as ``opt_state_partition_specs`` (the
    reference's specs, sanitized for the whole tensor's shape).  A rank
    holds 8 of the 128 experts, which "model" (16) does not divide: specs
    sanitized for the local shape would replicate the experts' moments
    over "model"."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(PRODUCTION_MOMENTS)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(x for x in proc.stdout.splitlines() if x.startswith("RESULT"))
    got = json.loads(line[len("RESULT"):])
    assert any("experts" in k for k in got)
    assert {k: v for k, v in got.items() if v[0] != v[1]} == {}
