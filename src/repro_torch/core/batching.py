"""Batched dispatch support: payload signatures, stacking, and the
adaptive per-service batch-size controller.

JJPF dispatches one task per round-trip per service (paper Algorithms 1-2).
The batched engine leases *compatible* tasks — same payload shape/dtype
tree — in groups, stacks them along a new leading axis, and runs ONE
``torch.func.vmap(fn)`` call per group.

The controller is deliberately simple: AIMD-style hill climbing toward a
per-batch latency target.  Slow services (large ``speed_factor``) converge
to small batches, fast services to large ones, which keeps the pull
scheduler's load balancing sharp — a slow node never hoards a huge lease.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch.utils import _pytree as pytree


# --------------------------------------------------------------------- #
# payload compatibility
# --------------------------------------------------------------------- #
def payload_signature(payload: Any) -> tuple:
    """Hashable (treespec, leaf shape/dtype) fingerprint of a payload.

    Two payloads with equal signatures can be stacked into one batch; this
    is also the shape component of the service's program-cache key.
    ``TreeSpec`` hashes and compares by structure (a dict's keys in
    insertion order), so equal signatures mean stackable payloads."""
    leaves, spec = pytree.tree_flatten(payload)
    leaf_sigs = tuple(
        (tuple(getattr(leaf, "shape", ())),
         str(getattr(leaf, "dtype", type(leaf).__name__)))
        for leaf in leaves)
    return (spec, leaf_sigs)


def stack_payloads(payloads: Sequence[Any]) -> Any:
    """Stack same-signature payload pytrees along a new leading axis."""
    return pytree.tree_map(lambda *xs: torch.stack([torch.as_tensor(x)
                                                    for x in xs]),
                           *payloads)


def bucket_size(n: int, max_batch: int) -> int:
    """Round a lease size up to the next power-of-two bucket (capped at
    ``max_batch``).  Padding tail batches to a bucket bounds the number of
    distinct batch shapes at ``log2(max_batch) + 2`` instead of one per
    ragged tail size."""
    b = 1
    while b < n:
        b *= 2
    return n if b > max_batch else b


def pow2_floor(x: float) -> int:
    """Largest power of two ≤ x (and ≥ 1) — batch sizes live on the
    power-of-two lattice so the cache bucketing stays bounded."""
    b = 1
    while b * 2 <= x:
        b *= 2
    return b


def pad_stacked(stacked: Any, n: int, m: int) -> Any:
    """Pad a stacked batch of ``n`` tasks up to ``m`` rows by repeating the
    last row (pure per-row programs never see their neighbours, so the
    padding rows are computed and discarded)."""
    if m <= n:
        return stacked
    return pytree.tree_map(
        lambda a: torch.cat([a, a[-1:].expand(m - n, *a.shape[1:])]),
        stacked)


class BatchResults(list):
    """Per-task results of one batch, with the CUDA event recorded on the
    service's stream after the batch was enqueued (``None`` on the CPU,
    where results are ready on return)."""

    def __init__(self, results, ready: "torch.cuda.Event | None" = None):
        super().__init__(results)
        self.ready = ready

    def wait(self) -> None:
        if self.ready is not None:
            self.ready.synchronize()


def unstack_results(result: Any, n: int) -> list:
    """Split a batched result pytree back into per-task results.  Slicing
    enqueues no device work, so the batch can stay in flight."""
    return [pytree.tree_map(lambda a: a[i], result) for i in range(n)]


# --------------------------------------------------------------------- #
# adaptive batch sizing
# --------------------------------------------------------------------- #
class AdaptiveBatchController:
    """Per-service batch-size hill climber, weighted by observed throughput.

    Doubles the batch while a batch completes in under half the latency
    target, halves it when a batch overruns the target, holds inside the
    [target/2, target] band.  Because the band spans exactly a factor of
    two, a monotone latency(batch) curve cannot oscillate: if latency(b)
    < target/2 then latency(2b) <= 2*latency(b) < target for any
    sub-linear-overhead service, so growth lands in (or below) the band.

    Heterogeneity-aware extensions:

    - **Throughput-weighted growth.**  The controller keeps a tasks/second
      EWMA; on a growth step it jumps straight to the power-of-two floor
      of ``throughput_ewma × target_latency_s`` (never below the plain
      doubling), so a fast service reaches its steady-state batch in O(1)
      growth steps instead of O(log max_batch).  The jump only fires on
      under-half-target batches, where ideal ≥ 2×current, so the
      band-hold stability argument above is untouched.
    - **Speed-factor capping.**  ``max_batch`` here is per service: the
      control thread derives it from the descriptor's advertised
      ``speed_factor`` (``max_batch / speed_factor``, power-of-two floor),
      so a node known to be k× slower can never hoard a full-size lease
      near the end of a stream.
    """

    def __init__(self, *, min_batch: int = 1, max_batch: int = 64,
                 initial: int | None = None,
                 target_latency_s: float = 0.05):
        if min_batch < 1 or max_batch < min_batch:
            raise ValueError(f"bad batch bounds [{min_batch}, {max_batch}]")
        self.min_batch = min_batch
        self.max_batch = max_batch
        self.target_latency_s = target_latency_s
        self.batch = min(max(initial or min_batch, min_batch), max_batch)
        self.last_latency_s: float | None = None
        self.throughput_ewma: float | None = None  # tasks / second
        self.batches_recorded = 0

    def next_batch(self) -> int:
        return self.batch

    def record(self, n_tasks: int, elapsed_s: float) -> None:
        """Feed back one completed batch (size actually leased, wall time
        from dispatch to materialized results)."""
        if n_tasks <= 0:
            return
        self.batches_recorded += 1
        self.last_latency_s = elapsed_s
        tput = n_tasks / max(elapsed_s, 1e-9)
        self.throughput_ewma = (tput if self.throughput_ewma is None
                                else 0.7 * self.throughput_ewma + 0.3 * tput)
        # only steer from full-size batches; a tail batch of 2 tasks says
        # nothing about how a full lease would behave
        if n_tasks < self.batch:
            return
        if elapsed_s < 0.5 * self.target_latency_s:
            grown = self.batch * 2
            suggestion = self._throughput_suggestion()
            if suggestion is not None:
                grown = max(grown, suggestion)
            self.batch = min(grown, self.max_batch)
        elif elapsed_s > self.target_latency_s:
            self.batch = max(self.batch // 2, self.min_batch)

    def _throughput_suggestion(self) -> int | None:
        """Batch size the observed throughput says would land exactly on
        the latency target (power-of-two floor); None until the EWMA has
        seen enough batches to trust."""
        if self.throughput_ewma is None or self.batches_recorded < 3:
            return None
        ideal = self.throughput_ewma * self.target_latency_s
        if ideal < 1.0:
            return None
        return max(self.min_batch, min(pow2_floor(ideal), self.max_batch))

    def stats(self) -> dict:
        return {
            "batch": self.batch,
            "max_batch": self.max_batch,
            "last_latency_s": self.last_latency_s,
            "throughput_ewma": self.throughput_ewma,
            "batches_recorded": self.batches_recorded,
        }


def speed_capped_max_batch(max_batch: int, speed_factor: float) -> int:
    """Per-service lease ceiling from the descriptor's advertised speed
    factor: a service k× slower than baseline is capped at the power-of-
    two floor of ``max_batch / k``, so pull scheduling stays sharp on
    heterogeneous clusters (the paper's NoW case).  ``speed_factor ≤ 1``
    (baseline or faster) keeps the full ceiling."""
    if speed_factor <= 1.0 or max_batch <= 1:
        return max_batch
    return max(1, min(max_batch, pow2_floor(max_batch / speed_factor)))
