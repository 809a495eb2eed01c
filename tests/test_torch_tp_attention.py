"""The port's tensor-parallel attention and re-meshing against the JAX
package's (``repro_torch.kernels.{flash,decode}_attention.sharded`` and
``repro_torch.runtime.elastic`` against ``repro``'s).

``plan_heads`` equals the reference's (every ``HeadPlan`` field) for every
(H, K) with K | H, H <= 64, at tp in {1, 2, 4, 8, 16}, and
``viable_mesh_shape`` equals the reference's over n <= 600 devices, model
in {1, 2, 4, 8, 16} and ``prefer_pods`` <= 3, raising where it raises.

On spawned gloo worlds of 4 and 2 CPU ranks (a ``FileStore`` under the
test's ``tmp_path``; each world joined under its own time limit, its
ranks killed on failure), ``flash_attention_tp`` (forward and gradients,
through ``local_map`` over the "model" axis) and ``decode_attention_tp``
(``cache_index`` at the start, the middle and the end; windowed) are held
to the reference's unsharded ``flash_attention_xla`` and
``decode_attention_xla`` at 2e-5 (forward) and 1e-3 (gradients) in fp32:
(H, K, tp) = (4, 2, 4) with duplicated kv heads, (6, 6, 4) a padded MHA,
(8, 2, 2) divisible on a (data, model) = (2, 2) mesh and on a (1, 2) one,
and windowed calls.  The inputs are DTensors as a model gives them: q, k
and v with the batch over "data" and the heads over "model" where they
divide, the decode caches laid out by ``cache_partition_specs``.
``make_elastic_mesh`` builds a mesh over the first ranks of the world.

On one process: the decode's log-sum-exp (``return_lse``) against the
scores', and the chunks' merge (``chunk_decode``, ``merge_chunks``)
serialized against the unsharded decode.
"""

import itertools
import multiprocessing
import queue
import time
import traceback

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.sharded import plan_heads
from repro_torch.runtime.elastic import viable_mesh_shape

# The JAX package is imported inside the tests: the spawned ranks import
# this module to find their function, and need only the port.
FWD_TOL, GRAD_TOL = 2e-5, 1e-3
WORLD_TIMEOUT_S = 180


def _rank_main(fn, rank, world, store_path, results):
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                                rank=rank, world_size=world)
        try:
            results.put((rank, True, fn(rank, world)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_world(fn, world: int, tmp_path, timeout: float = WORLD_TIMEOUT_S) -> dict:
    """``fn(rank, world)`` on ``world`` spawned CPU ranks of one gloo group
    (a ``FileStore`` under ``tmp_path``); returns {rank: result}.  The
    world is given ``timeout`` seconds in all; on a failure or at the
    limit every rank still running is killed, so no test can hang."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    store = str(tmp_path / "store")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, store, results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    out = {}
    try:
        while len(out) < world:
            try:
                rank, ok, res = results.get(timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                raise AssertionError(f"a world of {world} ranks did not finish in "
                                     f"{timeout} s; ranks done: {sorted(out)}") from None
            if not ok:
                raise AssertionError(f"rank {rank} of {world} failed:\n{res}")
            out[rank] = res
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1))
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5)


@pytest.fixture(autouse=True)
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("tp", [1, 2, 4, 8, 16])
def test_plan_heads_is_the_references(tp):
    from repro.kernels.flash_attention.sharded import plan_heads as jplan_heads

    for H in range(1, 65):
        for K in (k for k in range(1, H + 1) if H % k == 0):
            got, want = plan_heads(H, K, tp), jplan_heads(H, K, tp)
            assert (got is None) == (want is None), (H, K, tp)
            if got is not None:
                for field in ("tp", "Hp", "Kp", "q_src", "kv_src", "inv"):
                    assert getattr(got, field) == getattr(want, field), (H, K, tp, field)


@pytest.mark.parametrize("model", [1, 2, 4, 8, 16])
def test_viable_mesh_shape_is_the_references(model):
    from repro.runtime.elastic import viable_mesh_shape as jviable

    for n, pods in itertools.product(range(1, 601), (1, 2, 3)):
        try:
            want = jviable(n, model=model, prefer_pods=pods)
        except ValueError:
            with pytest.raises(ValueError, match="cannot keep"):
                viable_mesh_shape(n, model=model, prefer_pods=pods)
            continue
        assert viable_mesh_shape(n, model=model, prefer_pods=pods) == want, (n, model, pods)


# (name, mesh shape (data, model), B, Sq, H, K, D, window)
FLASH_CASES = {
    4: [("duplicated kv heads (4, 2, 4)", (1, 4), 2, 12, 4, 2, 8, None),
        ("padded MHA (6, 6, 4)", (1, 4), 2, 12, 6, 6, 8, None),
        ("divisible (8, 2, 2), data 2", (2, 2), 2, 12, 8, 2, 8, None),
        ("windowed, duplicated", (1, 4), 2, 16, 4, 2, 8, 5)],
    2: [("divisible (8, 2, 2)", (1, 2), 2, 12, 8, 2, 8, None),
        ("windowed, divisible", (1, 2), 1, 16, 4, 2, 8, 6)],
}
# (name, mesh shape, B, S, H, K, D, window, cache_index)
DECODE_CASES = {
    4: [(f"{tag} (4, 2, 4), cache_index {ci}", (1, 4), 2, 24, 4, 2, 8, None, ci)
        for tag, ci in (("start", 0), ("middle", 11), ("end", 23))]
    + [("windowed (8, 2, 2), data 2", (2, 2), 2, 24, 8, 2, 8, 5, 17),
       ("batch not over data (falls back)", (2, 2), 1, 24, 4, 2, 8, None, 9)],
    2: [(f"{tag} (8, 2, 2), cache_index {ci}", (1, 2), 2, 20, 8, 2, 8, None, ci)
        for tag, ci in (("start", 0), ("middle", 9), ("end", 19))]
    + [("windowed, end", (1, 2), 2, 20, 8, 2, 8, 4, 19)],
}


def _flash_inputs(B, S, H, K, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, D), (B, S, K, D), (B, S, K, D), (B, S, H, D))]


def _decode_inputs(B, S, H, K, D, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, 1, H, D), (B, S, K, D), (B, S, K, D))]


def _tp_world(rank, world):
    """One rank: every case of its world size, under a (data, model) mesh
    of the case's shape; returns {name: numpy results}."""
    from repro_torch.kernels.decode_attention.sharded import decode_attention_tp
    from repro_torch.kernels.flash_attention.sharded import flash_attention_tp
    from repro_torch.runtime.elastic import make_elastic_mesh
    from repro_torch.sharding.hints import mesh_axes, use_mesh
    from repro_torch.sharding.specs import P, cache_partition_specs, distribute, mesh_sizes

    heads = P("data", None, "model", None)  # as the projections give them, where they divide
    out = {}
    for name, shape, B, S, H, K, D, window in FLASH_CASES[world]:
        mesh = make_elastic_mesh(shape, device_type="cpu")
        q, k, v = (distribute(torch.from_numpy(a), heads, mesh).requires_grad_()
                   for a in _flash_inputs(B, S, H, K, D)[:3])
        g = distribute(torch.from_numpy(_flash_inputs(B, S, H, K, D)[3]), heads, mesh)
        with use_mesh(mesh), mesh_axes(mesh.mesh_dim_names):
            o = flash_attention_tp(q, k, v, causal=True, window=window)
            o.backward(g)
        out[name] = [t.full_tensor().detach().numpy() for t in (o, q.grad, k.grad, v.grad)]
    for name, shape, B, S, H, K, D, window, ci in DECODE_CASES[world]:
        mesh = make_elastic_mesh(shape, device_type="cpu")
        q, kc, vc = (torch.from_numpy(a) for a in _decode_inputs(B, S, H, K, D))
        sizes = mesh_sizes(mesh)
        spec = cache_partition_specs([{"k": kc}], mesh.mesh_dim_names, global_batch=B,
                                     dp_size=sizes["data"], axis_sizes=sizes)[0]["k"]
        q = distribute(q, heads, mesh)
        kc, vc = (distribute(c, spec, mesh) for c in (kc, vc))
        with use_mesh(mesh), mesh_axes(mesh.mesh_dim_names):
            o = decode_attention_tp(q, kc, vc, cache_index=ci, window=window)
        out[name] = o.full_tensor().numpy()
    if world == 4:  # a mesh over the first two ranks of the world
        sub = make_elastic_mesh((2, 1), device_type="cpu")
        coord = sub.get_coordinate()
        out["first two ranks"] = None if coord is None else tuple(coord)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {n: run_world(_tp_world, n, tmp_path_factory.mktemp(f"world{n}"))
            for n in (4, 2)}


@pytest.mark.parametrize("world,case", [(n, c) for n in (4, 2) for c in FLASH_CASES[n]])
def test_flash_attention_tp_matches_the_reference(worlds, world, case):
    import jax
    import jax.numpy as jnp

    from repro.kernels.flash_attention.xla import flash_attention_xla

    name, _, B, S, H, K, D, window = case
    q, k, v, g = _flash_inputs(B, S, H, K, D)
    out, vjp = jax.vjp(lambda a, b, c: flash_attention_xla(a, b, c, True, window),
                       *map(jnp.asarray, (q, k, v)))
    want = [out, *vjp(jnp.asarray(g))]
    for rank, res in worlds[world].items():
        for part, got, ref, tol in zip(("out", "dq", "dk", "dv"), res[name], want,
                                       (FWD_TOL,) + (GRAD_TOL,) * 3):
            np.testing.assert_allclose(got, np.asarray(ref), atol=tol, rtol=tol,
                                       err_msg=f"{name}: rank {rank} {part}")


@pytest.mark.parametrize("world,case", [(n, c) for n in (4, 2) for c in DECODE_CASES[n]])
def test_decode_attention_tp_matches_the_reference(worlds, world, case):
    import jax.numpy as jnp

    from repro.models.attention import decode_attention_xla as jdecode

    name, _, B, S, H, K, D, window, ci = case
    q, kc, vc = _decode_inputs(B, S, H, K, D)
    want = jdecode(*map(jnp.asarray, (q, kc, vc)), cache_index=ci, window=window)
    for rank, res in worlds[world].items():
        np.testing.assert_allclose(res[name], np.asarray(want), atol=FWD_TOL, rtol=FWD_TOL,
                                   err_msg=f"{name}: rank {rank}")


def test_elastic_mesh_takes_the_first_ranks(worlds):
    got = {rank: res["first two ranks"] for rank, res in worlds[4].items()}
    assert got == {0: (0, 0), 1: (1, 0), 2: None, 3: None}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_returns_the_scores_log_sum_exp(dtype):
    from repro_torch.kernels.decode_attention import decode_attention_fwd

    B, S, H, K, D, ci = 2, 20, 8, 2, 16, 13
    q, kc, vc = (torch.from_numpy(a).to(dtype) for a in _decode_inputs(B, S, H, K, D))
    out, lse = decode_attention_fwd(q, kc, vc, cache_index=ci, return_lse=True)
    assert torch.equal(out, decode_attention_fwd(q, kc, vc, cache_index=ci))
    s = torch.einsum("bkgd,bskd->bkgs", q.float().reshape(B, K, H // K, D),
                     kc.float()[:, :ci + 1]) * D ** -0.5
    assert lse.dtype == torch.float32 and lse.shape == (B, H)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1).reshape(B, H), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("tp", [2, 4, 5])
@pytest.mark.parametrize("window", [None, 7])
def test_chunk_merge_is_the_unsharded_decode(tp, window):
    """Each chunk's (out, lse), stacked and merged, against the unsharded
    decode at every cache_index, chunks wholly past it included."""
    from repro_torch.kernels import local_decode
    from repro_torch.kernels.decode_attention.sharded import chunk_decode, merge_chunks

    B, S, H, K, D = 2, 20, 8, 2, 16
    q, kc, vc = (torch.from_numpy(a) for a in _decode_inputs(B, S, H, K, D))
    sl = S // tp

    def stacked(x, op):
        return x.amax(0) if op == "max" else x.sum(0)

    for ci in range(S):
        parts = [chunk_decode(q, kc[:, i * sl:(i + 1) * sl], vc[:, i * sl:(i + 1) * sl],
                              start=i * sl, cache_index=ci, window=window) for i in range(tp)]
        out, lse = (torch.stack(t) for t in zip(*parts))
        got = merge_chunks(out, lse, stacked)
        want = local_decode(q, kc, vc, cache_index=ci, window=window)
        torch.testing.assert_close(got, want, atol=FWD_TOL, rtol=FWD_TOL,
                                   msg=lambda m: f"cache_index {ci}: {m}")
