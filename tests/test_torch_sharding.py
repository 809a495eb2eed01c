"""The port's partition specs and sharding hints against the JAX package's
(``repro_torch.sharding`` against ``repro.sharding``), all on shapes only.

Every arch's spec for every named parameter equals the reference's for
the parameter's path in the reference's tree (``interop._source``), the
stacked layer axis dropped, in ``mode="train"`` and ``"serve"`` on
("pod", "data", "model"), and sanitized under the reference suite's
{"pod": 2, "data": 16, "model": 16}; the reference suite's coverage (more
than 99% of the bytes sharded) and divisibility (under 2% padded) checks
hold over ``ModelAPI.param_specs()``, built on the meta device; batch and
cache specs (B = 1 sharding the sequence), ``spec_for`` of every kind,
``opt_state_partition_specs`` with fp32, bf16 and int8 moments and with
``master``, and ``shard_hint`` returning its argument itself without a
mesh.  The registry's shape stand-ins are the reference's shapes and
dtypes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.configs as jcfgs
import repro_torch.configs as tcfgs
from repro.models import SHAPES as JSHAPES
from repro.models import build as jbuild
from repro.models.registry import cell_applicable as jcell_applicable
from repro.optim.adamw import init_opt_state as jinit_opt_state
from repro.optim.adamw import opt_state_partition_specs as jopt_specs
from repro.sharding import hints as jhints
from repro.sharding import specs as jspecs
from repro_torch.interop import _source
from repro_torch.models import build as tbuild
from repro_torch.models.registry import SHAPES, ShapeCell, cell_applicable
from repro_torch.optim import init_opt_state, opt_state_partition_specs
from repro_torch.sharding import hints, specs

AXES3 = ("pod", "data", "model")
MESH_SIZES = {"pod": 2, "data": 16, "model": 16}
MODES = ("train", "serve")


def _norm(spec):
    """A spec as a plain tuple; a one-axis tuple entry is its axis (jax's
    ``PartitionSpec`` keeps ("data",) as "data")."""
    return tuple((e[0] if len(e) == 1 else tuple(e)) if isinstance(e, (tuple, list)) else e
                 for e in spec)


def _ref_leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


_REF_TREES: dict = {}


def _ref_tree(arch):
    if arch not in _REF_TREES:
        _REF_TREES[arch] = jbuild(jcfgs.get(arch)).param_specs()
    return _REF_TREES[arch]


def _ref_spec(arch, name, mode, axis_sizes=None):
    """The reference's spec of the port parameter ``name``, without the
    stacked axis."""
    cfg = tcfgs.get(arch)
    path, index = _source(name, cfg)
    leaf = _ref_leaf(_ref_tree(arch), path)
    spec = jspecs.sanitize_spec(jspecs.param_spec("/".join(path), leaf, AXES3, mode=mode),
                                leaf.shape, axis_sizes)
    spec = _norm(spec) + (None,) * (leaf.ndim - len(spec))
    if index is not None:
        assert spec[0] is None, (name, spec)
        spec = spec[1:]
    return spec


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", tcfgs.ARCH_IDS)
def test_param_specs_are_the_references(arch, mode):
    api = tbuild(tcfgs.get(arch))
    named = api.param_specs()
    assert all(p.device.type == "meta" for p in named.values())
    for sizes in (None, MESH_SIZES):
        got = specs.tree_partition_specs(named, AXES3, sizes, mode, cfg=api.cfg)
        assert got.keys() == named.keys()
        for name, spec in got.items():
            want = _ref_spec(arch, name, mode, sizes)
            have = _norm(spec) + (None,) * (named[name].ndim - len(spec))
            assert have == want, (arch, mode, sizes, name, spec, want)


def test_a_model_and_its_named_shapes_give_the_same_specs():
    cfg = tcfgs.reduced(tcfgs.get("llama3p2_1b"))
    model = tbuild(cfg).init(torch.Generator().manual_seed(0))
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert (specs.tree_partition_specs(model, AXES3, MESH_SIZES)
            == specs.tree_partition_specs(shapes, AXES3, MESH_SIZES, cfg=cfg))
    with pytest.raises(ValueError, match="cfg"):
        specs.tree_partition_specs(shapes, AXES3)


def _bytes(named, spec_of):
    total = sharded = padded = 0
    for name, p in named.items():
        spec = spec_of[name]
        total += p.numel()
        if any(s is not None for s in spec):
            sharded += p.numel()
        for dim, ax in zip(p.shape, tuple(spec)):
            if ax is None:
                continue
            k = int(np.prod([MESH_SIZES[a] for a in (ax if isinstance(ax, tuple) else (ax,))]))
            if dim % k:
                padded += p.numel()
                break
    return total, sharded, padded


@pytest.mark.parametrize("arch", tcfgs.ARCH_IDS)
def test_param_specs_coverage(arch):
    """The reference suite's check: the overwhelming majority of the
    parameter bytes are sharded."""
    api = tbuild(tcfgs.get(arch))
    named = api.param_specs()
    total, sharded, _ = _bytes(named, specs.tree_partition_specs(named, AXES3, cfg=api.cfg))
    assert sharded / total > 0.99, f"{arch}: only {sharded / total:.2%} sharded"


@pytest.mark.parametrize("arch", ["qwen3_1p7b", "llama4_maverick_400b_a17b",
                                  "jamba_1p5_large_398b"])
def test_param_specs_mostly_divisible(arch):
    api = tbuild(tcfgs.get(arch))
    named = api.param_specs()
    total, _, padded = _bytes(named, specs.tree_partition_specs(named, AXES3, cfg=api.cfg))
    assert padded / total < 0.02, f"{arch}: {padded / total:.2%} padded"


def test_sanitize_spec_is_the_references():
    P = specs.P
    cases = [(P("model", "data"), (151936, 2048)), (P("model", "data"), (122753, 2048)),
             (P(None, ("data", "model")), (2048, 1024)), (P(None, ("data", "model")), (2048, 24)),
             (P(("pod", "data"), None), (1, 4096)), (P(("pod", "data"), None), (64, 4096)),
             (P("model"), (40,)), (P(), (3, 5)), (P(None, "model", None), (8, 48, 2))]
    for spec, shape in cases:
        want = jspecs.sanitize_spec(JP(*spec), shape, MESH_SIZES)
        assert _norm(specs.sanitize_spec(spec, shape, MESH_SIZES)) == _norm(want)
        assert specs.sanitize_spec(spec, shape, None) == spec


@pytest.mark.parametrize("B", [8, 1])
def test_batch_specs_are_the_references(B):
    batch = {"tokens": np.zeros((B, 16), np.int32), "cache_index": np.zeros((), np.int32),
             "patch_embeds": np.zeros((B, 4, 8), np.float32)}
    for sizes in (None, MESH_SIZES):
        want = jspecs.batch_partition_specs({k: jnp.asarray(v) for k, v in batch.items()},
                                            AXES3, sizes)
        got = specs.batch_partition_specs({k: torch.from_numpy(v) for k, v in batch.items()},
                                          AXES3, sizes)
        assert {k: _norm(v) for k, v in got.items()} == {k: _norm(v) for k, v in want.items()}
    assert specs.batch_partition_specs(
        {"tokens": torch.zeros(8, 16, dtype=torch.int32)}, AXES3)["tokens"] == specs.P(
        ("pod", "data"), None)


def _port_caches(arch, batch, seq):
    api = tbuild(tcfgs.get(arch))
    from repro_torch.models.layers import META_INIT

    return api.make_caches(api.init(META_INIT), batch, seq)


@pytest.mark.parametrize("arch", ["llama3p2_1b", "minicpm3_4b", "jamba_1p5_large_398b",
                                  "whisper_tiny"])
@pytest.mark.parametrize("B", [128, 1])
def test_cache_specs_are_the_references(arch, B):
    """Per layer, the reference's spec of its stacked cache without the
    stack axis; B = 1 puts the sharding on the sequence."""
    cfg = tcfgs.get(arch)
    jcache = jax.eval_shape(lambda: jbuild(jcfgs.get(arch)).make_caches(B, 1024))
    tcache = _port_caches(arch, B, 1024)
    for sizes in (None, MESH_SIZES):
        want = jspecs.cache_partition_specs(jcache, AXES3, global_batch=B, dp_size=32,
                                            axis_sizes=sizes)
        got = specs.cache_partition_specs(tcache, AXES3, global_batch=B, dp_size=32,
                                          axis_sizes=sizes)
        assert len(got) == cfg.n_layers
        for layer, spec_tree in enumerate(got):
            # the reference's block caches sit under their mixer's name
            ref = (want if cfg.is_encoder_decoder else
                   next(iter(want[f"b{layer % len(cfg.pattern)}"].values())))
            for key, spec in spec_tree.items():
                subs = spec.items() if isinstance(spec, dict) else [(None, spec)]
                for sub, s in subs:
                    r = ref[key] if sub is None else ref[key][sub]
                    assert _norm(r)[0] is None
                    assert _norm(s) == _norm(r)[1:], (arch, B, layer, key, sub, s, r)
    if arch == "llama3p2_1b" and B == 1:
        flat = specs.cache_partition_specs(tcache, AXES3, global_batch=1, dp_size=32)
        assert all(c["k"][1] == AXES3 and c["v"][1] == AXES3 for c in flat)


@pytest.mark.parametrize("kind", ["activations", "logits", "batch_tokens", "moe_dispatch",
                                  "moe_expert_batch"])
@pytest.mark.parametrize("axes", [AXES3, ("data", "model"), ("data",), ("model",)])
def test_spec_for_every_kind_is_the_references(kind, axes):
    for ndim in (2, 3, 4):
        assert _norm(hints.spec_for(kind, axes, ndim)) == _norm(jhints.spec_for(kind, axes, ndim))
    with pytest.raises(KeyError):
        hints.spec_for("no such kind", axes, 2)


@pytest.mark.parametrize("moments,master", [("float32", False), ("bfloat16", False),
                                            ("int8", False), ("float32", True)])
def test_opt_state_specs_are_the_references(moments, master):
    arch = "qwen3_1p7b"
    jcfg = jcfgs.get(arch).replace(n_layers=2)
    tcfg = tcfgs.get(arch).replace(n_layers=2)
    japi, tapi = jbuild(jcfg), tbuild(tcfg)
    jparams = japi.param_specs()
    jstate = jax.eval_shape(lambda: jinit_opt_state(
        japi.init(jax.random.PRNGKey(0)), moment_dtype=moments, master_fp32=master))
    named = tapi.param_specs()
    tstate = init_opt_state(named, moment_dtype=moments, master_fp32=master)
    for sizes in (None, MESH_SIZES):
        jp = jspecs.tree_partition_specs(jparams, AXES3, sizes)
        want = jopt_specs(jstate, jp, AXES3, sizes)
        tp = specs.tree_partition_specs(named, AXES3, sizes, cfg=tcfg)
        got = opt_state_partition_specs(tstate, tp, AXES3, sizes)
        assert got["step"] == specs.P() and _norm(want["step"]) == ()
        assert ("master" in got) == master == ("master" in want)
        for name in named:
            path, index = _source(name, tcfg)
            for part in ("m", "v") + (("master",) if master else ()):
                r, s = _ref_leaf(want[part], path), got[part][name]
                pairs = ([(s[k], r[k]) for k in ("codes", "scale", "offset")]
                         if isinstance(s, dict) else [(s, r)])
                for mine, ref in pairs:
                    ref = _norm(ref)
                    if index is not None:
                        assert ref[0] is None
                        ref = ref[1:]
                    assert _norm(mine) == ref, (moments, sizes, part, name, mine, ref)


def test_shard_hint_returns_its_argument_without_a_mesh():
    x = torch.ones(4, 8, 16)
    assert hints.shard_hint(x, "activations") is x
    with hints.mesh_axes(AXES3):  # axes but a plain tensor: still itself
        assert hints.current_axes() == AXES3
        assert hints.shard_hint(x, "logits") is x
    assert hints.current_axes() is None and hints.current_mesh() is None
    with hints.mesh_axes(None):
        assert hints.current_axes() is None


def test_use_mesh_keeps_implicit_replication_until_the_last_one_leaves():
    """DTensor's implicit replication is one flag of the process: a nested
    use_mesh, or one that another thread leaves, must not clear it under
    a use_mesh still entered."""
    import threading

    from torch.distributed.tensor import DTensor

    def on():
        return DTensor._op_dispatcher._allow_implicit_replication

    assert not on()
    with hints.use_mesh("outer") as m:
        assert m == "outer" and hints.current_mesh() == "outer" and on()
        with hints.use_mesh("inner"):
            assert hints.current_mesh() == "inner" and on()
        assert hints.current_mesh() == "outer" and on()
        entered, leave, seen = threading.Event(), threading.Event(), []

        def other():
            with hints.use_mesh("other"):
                seen.append(hints.current_mesh())
                entered.set()
                leave.wait(10)

        t = threading.Thread(target=other)
        t.start()
        assert entered.wait(10)
        assert hints.current_mesh() == "outer"  # per thread
        leave.set()
        t.join(10)
        assert seen == ["other"] and on()  # the other thread left; this one has not
    assert hints.current_mesh() is None and not on()


def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("data", "model")

    P = specs.P
    assert specs.placements(P(None, ("data", "model")), Mesh()) == [Shard(1), Shard(1)]
    assert specs.placements(P("model", "data"), Mesh()) == [Shard(1), Shard(0)]
    assert specs.placements(P(("pod", "data"), None), Mesh()) == [Shard(0), Replicate()]
    assert specs.placements(P(), Mesh()) == [Replicate(), Replicate()]
    with pytest.raises(ValueError, match="order"):
        specs.placements(P(("model", "data")), Mesh())


def test_shape_stand_ins_are_the_references():
    assert {k: (c.kind, c.seq_len, c.global_batch) for k, c in SHAPES.items()} == {
        k: (c.kind, c.seq_len, c.global_batch) for k, c in JSHAPES.items()}
    assert isinstance(SHAPES["train_4k"], ShapeCell)
    for arch in tcfgs.ARCH_IDS:
        tapi, japi = tbuild(tcfgs.get(arch)), jbuild(jcfgs.get(arch))
        for shape in SHAPES:
            assert cell_applicable(tapi.cfg, shape) == jcell_applicable(japi.cfg, shape)
            got = tapi.input_specs(shape, batch_override=2)
            want = japi.input_specs(shape, batch_override=2)
            assert got.keys() == want.keys()
            for k, t in got.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(want[k].shape), (arch, shape, k)
                assert str(t.dtype).split(".")[-1] == str(want[k].dtype), (arch, shape, k)
    api = tbuild(tcfgs.get("qwen3_1p7b"))
    caches = api.cache_specs("decode_32k", batch_override=2)
    assert len(caches) == 28 and caches[0]["k"].shape == (2, 32768, 8, 128)
    assert caches[0]["k"].device.type == "meta"
    with pytest.raises(ValueError, match="decode"):
        api.cache_specs("train_4k")


def test_spmd_modules_import_neither_jax_nor_repro():
    """The SPMD layer's modules, imported alone in a fresh interpreter,
    bring in no JAX and nothing of the reference package."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    names = ["repro_torch.sharding.specs", "repro_torch.sharding.hints",
             "repro_torch.launch.mesh", "repro_torch.runtime.elastic",
             "repro_torch.kernels.flash_attention.chunked",
             "repro_torch.kernels.flash_attention.sharded",
             "repro_torch.kernels.decode_attention.sharded"]
    code = ("import importlib, sys\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
            "assert not bad, bad\n"
            "import torch.distributed as dist\n"
            "assert not dist.is_initialized()\n")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
