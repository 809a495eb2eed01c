"""The dry run's collectives on a fake ``cpu`` mesh are the card's: a DTensor
Shard -> Shard redistribution is the one all-to-all it is on the card, and a
point-to-point exchange is the reference's collective-permute, each with the
bytes the reference's ``analyze_hlo`` gives the same program.

- A (8, 8) fp32 tensor laid out Shard(0) on a fake 4-rank ``cpu`` mesh,
  redistributed to Shard(1) under ``dryrun.faked``: one all-to-all of a
  (8, 2) local result, 64 bytes and 48 wire bytes ((g - 1) / g of them), no
  all-gather; the reference lowers P("model", None) -> P(None, "model") on 4
  placeholder devices to one all-to-all of the same bytes.  Outside
  ``faked`` DTensor keeps its fallback for gloo (an all-gather and a chunk),
  and ``faked`` restores the function it patched.
- Each rank's (2, 8) fp32 shard sent to the next rank (an all-to-all with
  one peer each way): one collective-permute of 64 result and 64 wire
  bytes, as the reference's ``ppermute`` of the same shards.
Both sides run in subprocesses (4 placeholder devices for jax, a fake
process group of 4 for the port), so no xdist worker keeps a group.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

PORT = """
import json
import torch
import torch.distributed._functional_collectives as funcol
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Shard, _collective_utils
from repro_torch.launch.dryrun import fake_world, faked
from repro_torch.launch.mesh import make_mesh
from repro_torch.utils.op_stats import OpStatsMode

original = _collective_utils.shard_dim_alltoall
out = {}
with fake_world(4):
    mesh = make_mesh((4,), ("model",), device_type="cpu")

    def reshard():
        x = DTensor.from_local(torch.zeros(2, 8), mesh, [Shard(0)])
        with OpStatsMode() as mode:
            y = x.redistribute(mesh, [Shard(1)])
        return {"local": list(y.to_local().shape), **mode.result.collectives.as_dict()}

    with faked(FakeTensorMode(allow_non_fake_inputs=True)):
        out["faked"] = reshard()
        with OpStatsMode() as mode:  # rank 0 sends to rank 1, takes from rank 3
            y = funcol.all_to_all_single(torch.zeros(16), [0, 0, 0, 16], [0, 16, 0, 0], mesh)
            y = y.wait() if isinstance(y, funcol.AsyncCollectiveTensor) else y
        out["permute"] = {"numel": y.numel(), **mode.result.collectives.as_dict()}
    out["restored"] = _collective_utils.shard_dim_alltoall is original
    out["gloo_fallback"] = reshard()
print("RESULT" + json.dumps(out))
"""

REFERENCE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch.mesh import make_mesh
from repro.utils.hlo import analyze_hlo

mesh = make_mesh((4,), ("model",))
x = jax.ShapeDtypeStruct((8, 8), jnp.float32)
out = {}
reshard = jax.jit(lambda t: t, in_shardings=NamedSharding(mesh, P("model", None)),
                  out_shardings=NamedSharding(mesh, P(None, "model")))
out["reshard"] = analyze_hlo(reshard.lower(x).compile().as_text()).collectives.as_dict()
permute = jax.jit(jax.shard_map(
    lambda t: jax.lax.ppermute(t, "model", [(i, (i + 1) % 4) for i in range(4)]),
    mesh=mesh, in_specs=P("model"), out_specs=P("model")))
out["permute"] = analyze_hlo(permute.lower(x).compile().as_text()).collectives.as_dict()
print("RESULT" + json.dumps(out))
"""


def _run(code: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(s for s in proc.stdout.splitlines() if s.startswith("RESULT"))
    return json.loads(line[len("RESULT"):])


@pytest.fixture(scope="module")
def runs():
    return {"port": _run(PORT), "reference": _run(REFERENCE)}


def test_a_shard_to_shard_redistribution_is_one_all_to_all(runs):
    got = runs["port"]["faked"]
    assert got["local"] == [8, 2]
    assert got["count"] == {"all-to-all": 1.0}
    assert got["result_bytes"] == {"all-to-all": 64.0}
    assert got["wire_bytes"] == {"all-to-all": 48.0}


def test_its_wire_bytes_are_the_references(runs):
    got, want = runs["port"]["faked"], runs["reference"]["reshard"]
    assert want["count"] == {"all-to-all": 1.0}
    assert {k: got[k] for k in want} == want


def test_outside_the_dry_run_dtensor_keeps_its_gloo_fallback(runs):
    port = runs["port"]
    assert port["restored"] is True
    assert port["gloo_fallback"]["count"] == {"all-gather": 1.0}
    assert port["gloo_fallback"]["local"] == [8, 2]


def test_a_one_peer_exchange_is_the_references_collective_permute(runs):
    got, want = runs["port"]["permute"], runs["reference"]["permute"]
    assert got["numel"] == 16
    assert want["count"] == {"collective-permute": 1.0}
    assert {k: got[k] for k in want} == want
    assert got["wire_bytes"] == {"collective-permute": 64.0}
