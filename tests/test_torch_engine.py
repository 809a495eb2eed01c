"""The port's farm engine: ``BasicClient`` over port ``Service``s on the
CPU, per-task and batched (``torch.func.vmap``), with a failing service,
and the device rule of its entry points."""

import threading
import time

import pytest
import torch

from repro_torch.core import (BasicClient, Farm, LookupService, Program, Seq,
                              Service, interpret)
from repro_torch.core.batching import (pad_stacked, payload_signature,
                                       stack_payloads, unstack_results)
from repro_torch.device import resolve_device
from repro_torch.obs.schema import STATS_SCHEMA, validate_engine_stats

torch.set_num_threads(2)


def _affine(p):
    return {"y": p["x"] * 2.0 + 1.0, "s": (p["x"] * p["x"]).sum()}


PROG = Program(_affine, name="affine")


def _tasks(n=24):
    return [{"x": torch.arange(6, dtype=torch.float32) + 0.5 * i} for i in range(n)]


def _run(max_batch):
    lookup = LookupService()
    for _ in range(3):
        Service(lookup, device="cpu").start()
    tasks = _tasks()
    out = []
    client = BasicClient(PROG, None, tasks, out, lookup=lookup,
                         max_batch=max_batch, lease_s=5.0)
    client.compute(timeout=60)
    return tasks, out, client.stats()


def _assert_equal(out, ref):
    assert len(out) == len(ref)
    for a, b in zip(out, ref):
        assert torch.equal(a["y"], b["y"])
        torch.testing.assert_close(a["s"], b["s"], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("max_batch", [1, 8])
def test_results_equal_interpret(max_batch):
    tasks, out, stats = _run(max_batch)
    _assert_equal(out, interpret(Farm(Seq(PROG)), tasks))
    assert stats["done"] == len(tasks)
    if max_batch > 1:  # the batched path ran, through vmap
        assert sum(b["batches_dispatched"]
                   for b in stats["batching"].values()) > 0


def test_failing_service_still_exact():
    """The only service at first fails at its second task; two services
    join once it is dead, and the failed task is rescheduled to them."""
    lookup = LookupService()
    first = Service(lookup, device="cpu")
    first.fail_after(1)
    first.start()

    def join_when_dead():
        deadline = time.monotonic() + 30
        while first.alive and time.monotonic() < deadline:
            time.sleep(0.005)
        for _ in range(2):
            Service(lookup, device="cpu").start()

    helper = threading.Thread(target=join_when_dead, daemon=True)
    helper.start()
    tasks = _tasks()
    out = []
    client = BasicClient(PROG, None, tasks, out, lookup=lookup, lease_s=5.0)
    client.compute(timeout=60)
    helper.join(timeout=30)
    assert not helper.is_alive() and not first.alive
    _assert_equal(out, interpret(Farm(Seq(PROG)), tasks))
    assert client.stats()["reschedules"] > 0


def test_stats_schema():
    _, _, stats = _run(8)
    assert stats["engine"]["schema"] == STATS_SCHEMA == "jjpf.stats/v1"
    validate_engine_stats(stats["engine"])


def test_payload_signature_is_a_structural_key():
    a = {"tokens": torch.zeros(2, 3, dtype=torch.int64), "meta": [1.0, 2.0]}
    b = {"tokens": torch.ones(2, 3, dtype=torch.int64), "meta": [3.0, 4.0]}
    sig_a, sig_b = payload_signature(a), payload_signature(b)
    assert sig_a == sig_b and hash(sig_a) == hash(sig_b)
    assert len({sig_a, sig_b}) == 1
    assert payload_signature({"tokens": torch.zeros(2, 4, dtype=torch.int64),
                              "meta": [1.0, 2.0]}) != sig_a
    assert payload_signature({"tokens": torch.zeros(2, 3, dtype=torch.int64),
                              "meta": (1.0, 2.0)}) != sig_a
    assert payload_signature({"tokens": torch.zeros(2, 3),
                              "meta": [1.0, 2.0]}) != sig_a


def test_stack_pad_unstack_round_trip():
    payloads = [{"x": torch.full((2,), float(i))} for i in range(3)]
    stacked = pad_stacked(stack_payloads(payloads), 3, 4)
    assert tuple(stacked["x"].shape) == (4, 2)
    assert torch.equal(stacked["x"][3], stacked["x"][2])
    rows = unstack_results(stacked, 3)
    assert [float(r["x"][0]) for r in rows] == [0.0, 1.0, 2.0]


def test_host_program_batches_as_a_loop():
    prog = Program(lambda x: x + 1, name="inc", host=True)
    lookup = LookupService()
    for _ in range(2):
        Service(lookup, device="cpu").start()
    out = []
    BasicClient(prog, None, list(range(10)), out, lookup=lookup,
                max_batch=4).compute(timeout=60)
    assert out == list(range(1, 11))


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Service(None)
    assert resolve_device("cpu") == torch.device("cpu")
    assert Service(None, device="cpu").device == torch.device("cpu")
