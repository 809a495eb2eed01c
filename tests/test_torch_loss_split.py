"""Work split across the ranks as the reference's partitioner splits it, on
gloo worlds of spawned CPU ranks: ``token_nll`` where "model" does not
divide the vocabulary (V = 511), against the JAX package's ``token_nll``,
and the halves of a column-parallel product's output (the Mamba in_proj's
x and z) handed to each rank's channels.

The table is laid out by its train spec P("model", "data"), which the
vocabulary sanitizes to P(None, "data"): each rank gathers the whole table
and takes its batch rows, and its table gradient's product covers the
columns of its share only, d / data of them, as the reference's partitioner
splits it (the "model" ranks of a data row take the data axis's pieces in
turn), all-reduced over "data" and swapped to the rank whose shard holds
them.  On a ("data", "model") = (2, 2) world (one "model" rank a piece) and
a (2, 4) world (two): the loss within 2e-4 and the gradients within 1e-3
of the reference's on every rank, the table's gradient laid out as the
table, and every table-gradient product on a rank (seen by a dispatch mode)
(V, d / 2).  A one-rank world is bit-identical to no mesh.

``split_channels`` of a (4, 6, 32) tensor laid out P("data", None,
"model") into its two halves: each half exactly the slice, laid out on the
rank's channels, and the gradient exactly the halves' gradients joined,
with one all-to-all each way and no all-gather.
"""

from functools import partial

import numpy as np
import pytest
import torch

from test_torch_tp_attention import run_world

V, B, S, D, CHUNK = 511, 4, 24, 16, 8
LOSS_TOL, GRAD_TOL = 2e-4, 1e-3
AXES = ("data", "model")


@pytest.fixture(autouse=True)
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs():
    rng = np.random.default_rng(6)
    return (rng.standard_normal((B, S, D)).astype(np.float32),
            (0.5 * rng.standard_normal((V, D))).astype(np.float32),
            rng.integers(0, V, (B, S)).astype(np.int32))


def _world(rank, world, shape):
    """One rank: ``token_nll`` and its gradients on ``shape``'s mesh (and,
    on one rank, without a mesh), the shapes of the rank's in-place
    table-gradient products, and the table gradient's placements."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models.loss import token_nll
    from repro_torch.runtime.elastic import make_elastic_mesh
    from repro_torch.sharding.hints import mesh_axes, split_channels, use_mesh
    from repro_torch.sharding.specs import P, distribute
    from repro_torch.utils.op_stats import OpStatsMode

    products = []

    class Products(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is torch.ops.aten.addmm_.default:
                products.append(list(out.shape))
            return out

    def full(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).detach()

    x, w, t = (torch.from_numpy(a) for a in _inputs())
    mesh = make_elastic_mesh(shape, device_type="cpu")
    with use_mesh(mesh), mesh_axes(AXES):
        xs = distribute(x, P("data"), mesh).requires_grad_()
        ws = distribute(w, P("model", "data"), mesh).requires_grad_()
        ts = distribute(t, P("data"), mesh)
        with Products():
            nll = token_nll(xs, ws, ts, CHUNK)
            dx, dtable = torch.autograd.grad(nll.sum(), (xs, ws))
    out = {"nll": full(nll).numpy(), "dx": full(dx).numpy(), "dtable": full(dtable).numpy(),
           "products": products, "placements": str(list(dtable.placements)),
           "table": str(list(ws.placements))}
    # the halves of a column-parallel output, and the gradient back
    y, wy = (torch.from_numpy(np.random.default_rng(s).standard_normal((4, 6, 32)).astype(
        np.float32)) for s in (7, 8))
    with use_mesh(mesh), mesh_axes(AXES), OpStatsMode() as mode:
        ys = distribute(y, P("data", None, "model"), mesh).requires_grad_()
        halves = split_channels(ys, 2)
        (dy,) = torch.autograd.grad(sum((h * wy[..., i * 16:(i + 1) * 16]).sum()
                                        for i, h in enumerate(halves)), ys)
    out["halves"] = [torch.equal(full(h), y[..., i * 16:(i + 1) * 16])
                     for i, h in enumerate(halves)] + [torch.equal(full(dy), wy)]
    out["halves_placements"] = [str(list(h.placements)) for h in halves]
    out["halves_collectives"] = dict(mode.result.collectives.count)
    if world == 1:
        x, w = x.requires_grad_(), w.requires_grad_()
        free = token_nll(x, w, t, CHUNK)
        free_dx, free_dtable = torch.autograd.grad(free.sum(), (x, w))
        out["bit_identical"] = all(torch.equal(a, b) for a, b in (
            (full(nll), free), (full(dx), free_dx), (full(dtable), free_dtable)))
    return out


@pytest.fixture(scope="module")
def reference():
    import jax
    import jax.numpy as jnp

    from repro.models.loss import token_nll

    x, w, t = (jnp.asarray(a) for a in _inputs())
    nll, vjp = jax.vjp(lambda x_, w_: token_nll(x_, w_, t, CHUNK), x, w)
    dx, dtable = vjp(jnp.ones_like(nll))
    return {"nll": np.asarray(nll), "dx": np.asarray(dx), "dtable": np.asarray(dtable)}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {shape: run_world(partial(_world, shape=shape), shape[0] * shape[1],
                             tmp_path_factory.mktemp("loss_split"), timeout=300)
            for shape in ((2, 2), (2, 4), (1, 1))}


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)])
def test_the_split_loss_matches_the_reference(reference, worlds, shape):
    for rank, got in worlds[shape].items():
        np.testing.assert_allclose(got["nll"], reference["nll"], atol=LOSS_TOL, rtol=LOSS_TOL,
                                   err_msg=f"{shape} rank {rank} nll")
        for key in ("dx", "dtable"):
            np.testing.assert_allclose(got[key], reference[key], atol=GRAD_TOL, rtol=GRAD_TOL,
                                       err_msg=f"{shape} rank {rank} {key}")


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)])
def test_each_rank_computes_d_over_data_columns_of_the_table_gradient(worlds, shape):
    for rank, got in worlds[shape].items():
        # the table: d over "data", whole over "model"; its gradient laid out alike
        assert got["table"] == "[Shard(dim=1), Replicate()]", (rank, got["table"])
        assert got["placements"] == got["table"], (rank, got["placements"])
        # one product a chunk, each (V, d / data)
        assert got["products"] == [[V, D // shape[0]]] * (S // CHUNK), (rank, got["products"])


def test_a_one_rank_world_is_bit_identical_to_no_mesh(worlds):
    got = worlds[(1, 1)][0]
    assert got["bit_identical"] is True
    assert got["products"] == [[V, D]] * (S // CHUNK)


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)])
def test_a_column_parallel_outputs_halves_reach_each_ranks_channels(worlds, shape):
    for rank, got in worlds[shape].items():
        assert got["halves"] == [True, True, True], rank
        assert got["halves_placements"] == ["[Shard(dim=0), Shard(dim=2)]"] * 2, rank
        # one all-to-all forward, one backward; nothing gathered (the one
        # all-reduce is the sum the gradient is taken of)
        count = got["halves_collectives"]
        assert count == {"all-to-all": 2.0, "all-reduce": 1.0}, (rank, count)
