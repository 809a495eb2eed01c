"""``proc://`` isolates a CUDA device-side assert, and a ``tcp://``
worker computes on the card, on the card.

An in-process service shares the client's CUDA context: a device-side
assert in one task poisons that context for every service and for the
client.  A ``proc://`` worker is a fresh interpreter with a context of
its own, so the assert fails that worker only: the client's context and
the other worker go on serving.

A ``tcp://`` worker registers itself into a network lookup server; the
handle resolved from the client's ``RemoteLookup`` reaches a worker on
``cuda:0`` whose bf16 product equals the client's own.

Marked ``cuda``: it needs a card and skips elsewhere.  The programs are
module-level functions of this file, shipped by reference (the card's
machine has no ``cloudpickle``): the workers get this directory on their
``PYTHONPATH``.

    PYTHONPATH=src python -m pytest -q -m cuda \
        tests/test_torch_cuda_transport.py
"""

import os
from pathlib import Path

import pytest
import torch

from repro_torch.core import Program, RemoteProgramError, resolve_handle
from repro_torch.core.errors import ServiceFailure
from repro_torch.launch.now import NowPool
from repro_torch.launch.tcp import TcpPool

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _torch_threads():
    """Two intra-op threads for each test of this file, the previous count
    afterwards (set per test, not at import: every xdist worker imports
    every test file)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _double(payload):
    return payload["x"] * 2.0


def _gather(payload):
    """``x[idx]`` on the worker's card; an index past the end trips the
    indexing kernel's device-side assert, reported at the synchronize."""
    out = payload["x"][payload["idx"]]
    torch.cuda.synchronize()
    return out


def _bf16_product(payload):
    """A bf16 product on the worker's device, and the device's name."""
    y = payload["a"] @ payload["b"]
    return {"y": y, "device": str(y.device)}


@pytest.fixture
def workers_import_this_file(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    here = str(Path(__file__).resolve().parent)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [here] + [p for p in [os.environ.get("PYTHONPATH")] if p]))


@pytest.fixture
def card_pool(workers_import_this_file):
    with NowPool(2, service_prefix="assert") as pool:  # on the card
        handles = [resolve_handle(w.descriptor) for w in pool.workers]
        try:
            yield pool, handles
        finally:
            for h in handles:
                h.close()


def test_device_assert_fails_only_its_worker(card_pool):
    pool, (a, b) = card_pool
    x = torch.arange(8.0)
    double = Program(_double, name="dbl")
    gather = Program(_gather, name="gather")
    ok = {"x": x, "idx": torch.tensor([1, 7])}
    for h in (a, b):  # both workers serve on the card
        assert torch.equal(h.execute(double, ok), x * 2.0)
        assert torch.equal(h.execute(gather, ok), x[[1, 7]])
    with pytest.raises((RemoteProgramError, ServiceFailure),
                       match="device-side assert|CUDA error"):
        a.execute(gather, {"x": x, "idx": torch.tensor([100])})
    # the assert poisoned worker a's context, and nothing else
    with pytest.raises((RemoteProgramError, ServiceFailure)):
        a.execute(double, ok)
    assert torch.equal(b.execute(double, ok), x * 2.0)
    assert torch.equal(b.execute(gather, ok), x[[1, 7]])
    assert torch.equal((x.cuda() * 2.0).cpu(), x * 2.0)  # the client's own
    assert pool.workers[1].alive


def test_tcp_worker_computes_bf16_on_the_card(workers_import_this_file):
    g = torch.Generator().manual_seed(0)
    a = torch.randn(64, 128, generator=g).to(torch.bfloat16)
    b = torch.randn(128, 32, generator=g).to(torch.bfloat16)
    with TcpPool(1, service_prefix="tcp-card") as pool:  # on the card
        (desc,) = pool.lookup.query()
        assert desc.endpoint == pool.workers[0].address
        assert desc.capabilities["device"] == "cuda:0"
        handle = resolve_handle(desc)
        try:
            out = handle.execute(Program(_bf16_product, name="bf16-product"),
                                 {"a": a, "b": b})
        finally:
            handle.close()
    assert out["device"] == "cuda:0"
    assert out["y"].dtype == torch.bfloat16 and out["y"].device.type == "cpu"
    assert torch.equal(out["y"], (a.cuda() @ b.cuda()).cpu())
