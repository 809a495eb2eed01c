"""The port's op-stream analysis (``repro_torch.utils.op_stats``) against the
reference's HLO analysis (``repro.utils.hlo.analyze_hlo``) on the same
programs, and each kernel's fake route and FLOP formula.

- A scan of 7 (64, 64) products, 5 x 3 nested scans of (32, 32) products:
  the reference weights the loop bodies by their trip counts, the port's
  eager loops dispatch every product; both equal 7·2·64³ and 5·3·2·32³.
- A (64, 64) x (64, 128) product laid out P("data", None) x P(None,
  "model") on a (2, 4) mesh: 131,072 FLOPs and 20,480 bytes a device on
  both sides.  ``FlopCounterMode`` counts the product on global shapes
  there, 1,048,576 (with DTensor's shape inference once more on a first
  call, 1,179,648 in all), and would fail the check.
- A (64, 64) fp32 sum sharded 4 ways: one all-reduce, 4 result bytes, 6
  wire bytes on both sides.
The sharded cases run in a subprocess (8 placeholder devices for jax, a
fake process group of 8 for the port), so no xdist worker keeps a group.

Each kernel op's formula equals ``FlopCounterMode``'s count of the
kernel's plain version at two shapes; fake CUDA tensors go through each
op (its fake impl), build and launch nothing, and raise on a shape the
kernel refuses, as the card would.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.utils.hlo import analyze_hlo
from repro_torch.kernels import KERNELS
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fl
from repro_torch.kernels import mamba_scan as ms
from repro_torch.utils.op_stats import EXTRA_FLOPS, analyze

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_chained_products_are_counted_as_the_references_trip_count():
    def f(x, w):
        def body(c, wi):
            return c @ wi, None
        c, _ = jax.lax.scan(body, x, w)
        return c.sum()

    hlo = jax.jit(f).lower(jax.ShapeDtypeStruct((64, 64), jnp.float32),
                           jax.ShapeDtypeStruct((7, 64, 64), jnp.float32)).compile().as_text()
    ws = torch.randn(7, 64, 64)

    def chain(c):
        for w in ws:
            c = c @ w
        return c.sum()

    _, got = analyze(chain, torch.randn(64, 64))
    assert got.dot_flops == analyze_hlo(hlo).dot_flops == 7 * 2 * 64 ** 3 == 3_670_016


def test_nested_loops_multiply_as_the_references_nested_scans():
    def f(x, w):
        def outer(c, wi):
            def inner(c2, _):
                return c2 @ wi, None
            c2, _ = jax.lax.scan(inner, c, None, length=3)
            return c2, None
        c, _ = jax.lax.scan(outer, x, w)
        return c.sum()

    hlo = jax.jit(f).lower(jax.ShapeDtypeStruct((32, 32), jnp.float32),
                           jax.ShapeDtypeStruct((5, 32, 32), jnp.float32)).compile().as_text()
    ws = torch.randn(5, 32, 32)

    def nested(c):
        for w in ws:
            for _ in range(3):
                c = c @ w
        return c.sum()

    _, got = analyze(nested, torch.randn(32, 32))
    assert got.dot_flops == analyze_hlo(hlo).dot_flops == 5 * 3 * 2 * 32 ** 3 == 983_040


def test_the_in_place_product_counts_as_addmm_and_torchs_registry_is_left_alone():
    """The loss's table gradient runs ``addmm_``: op_stats counts it as
    ``addmm``, and so does a ``FlopCounterMode`` given ``EXTRA_FLOPS``;
    the import leaves torch's own registry (every other
    ``FlopCounterMode``) as it was."""
    from torch.utils.flop_counter import flop_registry

    c, a, b = torch.zeros(16, 24), torch.randn(16, 32), torch.randn(32, 24)
    _, res = analyze(lambda: c.clone().addmm_(a, b))
    with FlopCounterMode(display=False, custom_mapping=EXTRA_FLOPS) as fc:
        c.clone().addmm_(a, b)
    assert res.dot_flops == fc.get_total_flops() == _plain_flops(torch.addmm, c, a, b) == (
        2 * 16 * 32 * 24)
    assert torch.ops.aten.addmm_ not in flop_registry
    assert _plain_flops(lambda: c.clone().addmm_(a, b)) == 0


SHARDED = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
import torch, torch.distributed as dist
import torch.testing._internal.distributed.fake_pg  # the "fake" backend
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.utils.flop_counter import FlopCounterMode
from repro.launch.mesh import make_mesh
from repro.utils.hlo import analyze_hlo
from repro_torch.launch.mesh import make_mesh as tmake_mesh
from repro_torch.utils.op_stats import analyze

out = {}
mesh = make_mesh((2, 4), ("data", "model"))
xs, ws = (jax.ShapeDtypeStruct(s, jnp.float32) for s in ((64, 64), (64, 128)))
with mesh:
    hlo = jax.jit(lambda x, w: x @ w, in_shardings=(
        NamedSharding(mesh, P("data", None)), NamedSharding(mesh, P(None, "model")))
    ).lower(xs, ws).compile().as_text()
a = analyze_hlo(hlo)
out["ref_product"] = [a.dot_flops, a.bytes_accessed, a.collectives.as_dict()]
mesh4 = make_mesh((4,), ("d",))
with mesh4:
    hlo = jax.jit(lambda x: x.sum(), in_shardings=NamedSharding(mesh4, P("d", None))
                  ).lower(xs).compile().as_text()
out["ref_sum"] = analyze_hlo(hlo).collectives.as_dict()

dist.init_process_group("fake", store=dist.HashStore(), rank=0, world_size=8)
tmesh = tmake_mesh((2, 4), ("data", "model"), device_type="cpu")
x = distribute_tensor(torch.randn(64, 64), tmesh, [Shard(0), Replicate()], src_data_rank=None)
w = distribute_tensor(torch.randn(64, 128), tmesh, [Replicate(), Shard(1)], src_data_rank=None)
y, a = analyze(torch.matmul, x, w)
out["product"] = [a.dot_flops, a.bytes_accessed, a.collectives.as_dict(),
                  str(list(y.placements))]
with FlopCounterMode(display=False) as fc:
    x @ w
out["flop_counter_mode"] = fc.get_total_flops()
dist.destroy_process_group()
dist.init_process_group("fake", store=dist.HashStore(), rank=0, world_size=4)
tmesh4 = tmake_mesh((4,), ("d",), device_type="cpu")
xs4 = distribute_tensor(torch.randn(64, 64), tmesh4, [Shard(0)], src_data_rank=None)
_, a = analyze(lambda t: t.sum().full_tensor(), xs4)
out["sum"] = a.collectives.as_dict()
dist.destroy_process_group()
print("RESULT" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def sharded():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(SHARDED)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(s for s in proc.stdout.splitlines() if s.startswith("RESULT"))
    return json.loads(line[len("RESULT"):])


def test_a_sharded_product_counts_one_devices_product_as_the_reference(sharded):
    flops, nbytes, coll, placed = sharded["product"]
    assert [flops, nbytes, coll] == sharded["ref_product"]
    assert (flops, nbytes) == (131_072, 20_480)
    assert coll["total_wire_bytes"] == 0
    assert placed == "[Shard(dim=0), Shard(dim=1)]"
    # FlopCounterMode counts the product on global shapes, 8x one device's
    assert sharded["flop_counter_mode"] >= 2 * 64 * 64 * 128 == 8 * flops


def test_a_sharded_sum_reduces_once_as_the_reference(sharded):
    assert sharded["sum"] == sharded["ref_sum"]
    assert sharded["sum"]["count"] == {"all-reduce": 1.0}
    assert sharded["sum"]["result_bytes"] == {"all-reduce": 4.0}
    assert sharded["sum"]["total_wire_bytes"] == 6.0


def _plain_flops(fn, *args, **kwargs) -> int:
    with FlopCounterMode(display=False) as m:
        fn(*args, **kwargs)
    return m.get_total_flops()


def _fake_cuda(*shapes, dtype=torch.float32):
    return [torch.empty(s, dtype=dtype, device="cuda") for s in shapes]


# (B, Sq, Skv, H, K, D, Dv)
FLASH = [(2, 64, 64, 8, 2, 128, 128), (1, 48, 80, 10, 2, 96, 64)]
DECODE = [(2, 100, 8, 2, 128, 40), (3, 64, 6, 6, 64, 63)]  # (B, S, H, K, D, cache_index)
SCAN = [(2, 64, 32, 16), (1, 40, 24, 8)]


@pytest.mark.parametrize("shape", FLASH)
def test_flash_formulas_are_the_plain_versions_products(shape):
    B, Sq, Skv, H, K, D, Dv = shape
    q, k, v = torch.randn(B, Sq, H, D), torch.randn(B, Skv, K, D), torch.randn(B, Skv, K, Dv)
    out, lse = fl.flash_attention_plain(q, k, v, causal=True)
    g = torch.randn_like(out)
    with FakeTensorMode():
        fq, fk, fv, fo, fg = _fake_cuda(q.shape, k.shape, v.shape, out.shape, g.shape,
                                        dtype=torch.bfloat16)
        (flse,) = _fake_cuda(lse.shape)
        _, fwd = analyze(fl.flash_attention_fwd, fq, fk, fv, causal=True)
        _, bwd = analyze(fl.flash_attention_bwd, fq, fk, fv, fo, flse, fg, causal=True)
    assert fwd.kernel_ops == {"flash_attention_fwd": 1}
    assert bwd.kernel_ops == {"flash_attention_bwd": 1}
    assert fwd.dot_flops == fwd.kernel_flops == _plain_flops(
        fl.flash_attention_plain, q, k, v, causal=True) == 2 * B * H * Sq * Skv * (D + Dv)
    assert bwd.dot_flops == _plain_flops(fl.flash_attention_bwd_plain, q, k, v, out, lse, g,
                                         causal=True) == 2 * B * H * Sq * Skv * (3 * D + 2 * Dv)


@pytest.mark.parametrize("shape", DECODE)
@pytest.mark.parametrize("return_lse", [False, True])
def test_decode_formula_is_the_plain_versions_products(shape, return_lse):
    B, S, H, K, D, ci = shape
    q, kc, vc = torch.randn(B, 1, H, D), torch.randn(B, S, K, D), torch.randn(B, S, K, D)
    with FakeTensorMode():
        fq, fk, fv = _fake_cuda(q.shape, kc.shape, vc.shape, dtype=torch.bfloat16)
        out, got = analyze(dec.decode_attention_fwd, fq, fk, fv, cache_index=ci,
                           return_lse=return_lse)
    name = "decode_attention_fwd_lse" if return_lse else "decode_attention_fwd"
    assert got.kernel_ops == {name: 1}
    if return_lse:
        assert [tuple(t.shape) for t in out] == [(B, 1, H, D), (B, H)]
    assert got.dot_flops == _plain_flops(dec.decode_attention_plain, q, kc, vc, cache_index=ci,
                                         return_lse=return_lse) == 2 * B * H * S * 2 * D


@pytest.mark.parametrize("shape", SCAN)
def test_scan_formula_is_the_plain_chunked_scans_products(shape):
    b, s, d, n = shape
    x, dt, B, C = torch.randn(b, s, d), torch.rand(b, s, d), torch.randn(b, s, n), \
        torch.randn(b, s, n)
    A = -torch.rand(d, n)
    with FakeTensorMode():
        fx, fdt, fA, fB, fC, fh = _fake_cuda(x.shape, dt.shape, A.shape, B.shape, C.shape,
                                             (b, d, n))
        (y, hf), got = analyze(ms.mamba_scan_fwd, fx, fdt, fA, fB, fC, fh)
    assert got.kernel_ops == {"mamba_scan_fwd": 1}
    assert (tuple(y.shape), tuple(hf.shape)) == ((b, s, d), (b, d, n))
    assert got.dot_flops == _plain_flops(ms.mamba_scan_plain, x, dt, A, B, C) == 2 * b * s * d * n


def test_fake_routes_build_and_launch_nothing_and_refuse_what_the_kernels_refuse():
    built = [k._fn for k in KERNELS]
    launches = [k.launches for k in KERNELS]
    with FakeTensorMode():
        # head dims no kernel takes (D = 16, (96, 32)), a state size past 32
        q, k = _fake_cuda((1, 8, 2, 16), (1, 8, 2, 16), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head dims"):
            fl.flash_attention_fwd(q, k, k)
        q, k, v = _fake_cuda((1, 8, 2, 96), (1, 8, 2, 96), (1, 8, 2, 32), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head dims"):
            fl.flash_attention_fwd(q, k, v)
        q, k, o, g = _fake_cuda((1, 8, 2, 16), (1, 8, 2, 16), (1, 8, 2, 16), (1, 8, 2, 16),
                                dtype=torch.bfloat16)
        (lse,) = _fake_cuda((1, 2, 8))
        with pytest.raises(ValueError, match="head dims"):
            fl.flash_attention_bwd(q, k, k, o, lse, g)
        q, k = _fake_cuda((1, 1, 2, 16), (1, 8, 2, 16), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head dims"):
            dec.decode_attention_fwd(q, k, k, cache_index=3)
        with pytest.raises(ValueError, match="cache_index"):
            dec.decode_attention_fwd(*_fake_cuda((1, 1, 2, 64), (1, 8, 2, 64), (1, 8, 2, 64),
                                                 dtype=torch.bfloat16), cache_index=8)
        x, dt, A, B, C = _fake_cuda((1, 8, 4), (1, 8, 4), (4, 64), (1, 8, 64), (1, 8, 64))
        with pytest.raises(ValueError, match="state size"):
            ms.mamba_scan_fwd(x, dt, A, B, C)
        q, k = _fake_cuda((70000, 4, 2, 64), (70000, 4, 2, 64), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="65535"):
            fl.flash_attention_fwd(q, k, k)
        # what the kernels take goes through their ops' fake impls
        q, k = _fake_cuda((2, 8, 4, 64), (2, 8, 2, 64), dtype=torch.bfloat16)
        out = fl.flash_attention(q, k, k)
        assert out.shape == q.shape and out.device.type == "cuda"
    assert [k._fn for k in KERNELS] == built == [None] * len(KERNELS)
    assert [k.launches for k in KERNELS] == launches
