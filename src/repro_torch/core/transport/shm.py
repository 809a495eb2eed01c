"""Same-host zero-copy fast path: pytree payloads over shared memory.

The ``proc://`` backend pays for every dispatch twice: the payload is
pickled into the frame, copied through the kernel socket buffers, and
unpickled on the far side — for cheap tasks that serialization *is* the
dominant per-dispatch cost.  ``shm://`` keeps the wire protocol
(frames still carry the envelope, the op, the program) but array leaves
(numpy arrays and tensors, a tensor's bytes copied to the CPU first by
``wire._to_host``) ride a :class:`ShmRing` — a
``multiprocessing.shared_memory`` segment used as a bump-allocated ring.
Only a tiny ``(name, offset, dtype, shape)`` descriptor crosses the
socket; the array bytes are one memcpy into the ring on the sending side
and one memcpy out on the receiving side (the attach-side copy is
deliberate: results outlive the ring slot, which is reused on the next
request).

Rings are per-direction and per-connection: the client's
:class:`~repro_torch.core.transport.shm.ShmHandle` creates the request ring
and announces it at ``hello``; the worker creates a reply ring per
connection and writes results into it.  Because a handle serializes its
requests (one outstanding request per connection), a message's ring
slots are consumed before the slot space can ever be reused — no
per-slot reference counting needed.  A leaf that does not fit the
remaining ring budget for the current message simply stays inline in the
pickle (graceful degradation, never corruption).

Descriptors resolve transparently at unpickle time: ``_ShmLeaf`` reduces
to :func:`load_shm_leaf`, so the receiving side's plain
``wire.load_pytree`` returns real numpy arrays (and tensors, whose
descriptor names a torch dtype such as ``"torch.bfloat16"``: the ring
holds their raw bytes) with no shm-specific code.  Cross-host delivery
of a descriptor fails loudly (no such segment) — ``shm://`` is
same-host by construction.
"""

from __future__ import annotations

import math
import pickle
import threading
from multiprocessing import shared_memory
from typing import Any

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .wire import _to_host

#: arrays below this stay inline in the pickle: a descriptor plus an
#: attach round-trip costs more than pickling a few hundred bytes
MIN_SHM_BYTES = 512

#: default ring capacity per direction per connection
DEFAULT_RING_BYTES = 16 << 20

_ALIGN = 64


class ShmRing:
    """Bump-allocated ring over one shared-memory segment (creator side).

    ``begin_message()`` resets the per-message budget; ``write(arr)``
    copies the array into the ring and returns its descriptor tuple, or
    None when the array does not fit the remaining budget (the caller
    leaves that leaf inline).  The budget guarantees one message can
    never wrap over its own earlier leaves."""

    def __init__(self, capacity: int = DEFAULT_RING_BYTES):
        self.capacity = int(capacity)
        self.shm = shared_memory.SharedMemory(create=True,
                                              size=self.capacity)
        self.name = self.shm.name
        with _ATTACH_LOCK:
            _LOCAL_RINGS.add(self.name)
        self._off = 0
        self._budget = self.capacity
        self._closed = False
        self.bytes_written = 0  # telemetry: payload bytes memcpy'd in
        self.inline_fallbacks = 0

    def begin_message(self) -> None:
        self._budget = self.capacity

    def write(self, arr: np.ndarray) -> tuple | None:
        nb = arr.nbytes
        if self._closed or nb == 0:
            return None
        pad = -(-nb // _ALIGN) * _ALIGN
        wrap = self._off + nb > self.capacity
        tail_skip = (self.capacity - self._off) if wrap else 0
        if pad + tail_skip > self._budget:
            self.inline_fallbacks += 1
            return None
        if wrap:  # tail_skip may be 0 when _off sits exactly at capacity
            self._off = 0
        dst = np.ndarray(arr.shape, arr.dtype, buffer=self.shm.buf,
                         offset=self._off)
        dst[...] = arr
        desc = (self.name, self._off, arr.dtype.str, tuple(arr.shape))
        self._off += pad
        self._budget -= pad + tail_skip
        self.bytes_written += nb
        return desc

    def close(self, *, unlink: bool = False) -> None:
        """Idempotent; ``unlink`` removes the segment (creator only)."""
        if self._closed:
            return
        self._closed = True
        with _ATTACH_LOCK:
            _LOCAL_RINGS.discard(self.name)
        try:
            self.shm.close()
        except OSError:
            pass
        if unlink:
            try:
                self.shm.unlink()
            except FileNotFoundError:
                pass


# --------------------------------------------------------------------- #
# attach side
# --------------------------------------------------------------------- #
_ATTACH_LOCK = threading.Lock()
# name -> SharedMemory, in LRU order (moved to the end on every use).
# Capped: a long-lived worker sees a fresh client ring per connection and
# must not keep every dead client's segment mapped forever.  A live ring
# that gets evicted under cache pressure simply re-attaches by name on
# next use (its creator has not unlinked it yet).
_ATTACHED: dict[str, shared_memory.SharedMemory] = {}
_ATTACH_CACHE_MAX = 16
#: rings created by THIS process (tracker bookkeeping, see _attach_locked)
_LOCAL_RINGS: set[str] = set()


def _attach_locked(name: str) -> shared_memory.SharedMemory:
    shm = _ATTACHED.pop(name, None)
    if shm is None:
        shm = shared_memory.SharedMemory(name=name)
        # Python < 3.13 registers attachments with the resource tracker,
        # which then unlinks the creator's segment when *we* exit; only
        # the creator may unlink.  Skip for rings created in-process: the
        # tracker holds ONE entry per name, and stripping it here would
        # make the creator's own unlink() double-unregister.
        if name not in _LOCAL_RINGS:
            try:
                from multiprocessing import resource_tracker
                resource_tracker.unregister(shm._name, "shared_memory")
            except Exception:
                pass
    _ATTACHED[name] = shm  # (re-)insert at LRU tail (dicts keep order)
    while len(_ATTACHED) > _ATTACH_CACHE_MAX:
        lru = next(iter(_ATTACHED))
        old = _ATTACHED.pop(lru)
        try:
            old.close()
        except OSError:
            pass
    return shm


def detach_all() -> None:
    """Drop all cached attachments (test hygiene)."""
    with _ATTACH_LOCK:
        for shm in _ATTACHED.values():
            try:
                shm.close()
            except OSError:
                pass
        _ATTACHED.clear()


_TORCH_DTYPE = "torch."


def load_shm_leaf(name: str, offset: int, dtype: str, shape: tuple):
    """Descriptor -> owned ndarray (or tensor, for a ``torch.*`` dtype,
    whose raw bytes the ring holds).  The copy is the point: the ring slot
    is reused on the next message, results must outlive it.  The copy
    happens under the attach lock so LRU eviction can never close a
    segment out from under a concurrent load."""
    tdtype = None
    if dtype.startswith(_TORCH_DTYPE):
        tdtype = getattr(torch, dtype[len(_TORCH_DTYPE):])
        raw_shape, raw_dtype = (math.prod(shape) * tdtype.itemsize,), np.uint8
    else:
        raw_shape, raw_dtype = shape, np.dtype(dtype)
    with _ATTACH_LOCK:
        shm = _attach_locked(name)
        out = np.ndarray(raw_shape, raw_dtype, buffer=shm.buf,
                         offset=offset).copy()
    if tdtype is None:
        return out
    return torch.from_numpy(out).view(tdtype).reshape(shape)


class _ShmLeaf:
    """Placeholder that unpickles straight into the array it describes."""

    __slots__ = ("name", "offset", "dtype", "shape")

    def __init__(self, name, offset, dtype, shape):
        self.name, self.offset = name, offset
        self.dtype, self.shape = dtype, shape

    def __reduce__(self):
        return (load_shm_leaf,
                (self.name, self.offset, self.dtype, self.shape))


def dump_pytree_shm(tree: Any, ring: ShmRing) -> bytes:
    """Like ``wire.dump_pytree`` but array leaves ≥ ``MIN_SHM_BYTES``
    ride the ring; only descriptors (and small/odd leaves) are pickled.
    The output loads with plain ``wire.load_pytree`` on the peer."""
    ring.begin_message()

    def conv(leaf):
        leaf = _to_host(leaf)
        if isinstance(leaf, torch.Tensor) and leaf.nbytes >= MIN_SHM_BYTES:
            # raw bytes: numpy has no view of every torch dtype (bf16)
            desc = ring.write(leaf.reshape(-1).view(torch.uint8).numpy())
            if desc is not None:
                return _ShmLeaf(desc[0], desc[1], str(leaf.dtype),
                                tuple(leaf.shape))
        elif (isinstance(leaf, np.ndarray) and not leaf.dtype.hasobject
                and leaf.nbytes >= MIN_SHM_BYTES):
            desc = ring.write(np.ascontiguousarray(leaf))
            if desc is not None:
                return _ShmLeaf(*desc)
        return leaf

    return pickle.dumps(pytree.tree_map(conv, tree),
                        protocol=pickle.HIGHEST_PROTOCOL)


# --------------------------------------------------------------------- #
# the shm:// backend: proc's socket protocol, ring-borne payloads
# --------------------------------------------------------------------- #
from ..errors import ServiceFailure  # noqa: E402
from .base import Transport, register_transport  # noqa: E402
from .proc import ProcHandle  # noqa: E402


class ShmHandle(ProcHandle):
    """A ``proc://`` handle whose payloads ride shared memory.

    Same socket, same ops, same liveness story (the worker is a real
    process that can be SIGKILLed) — but ``_dump`` writes array leaves
    into this handle's request ring and the worker's replies arrive as
    descriptors into its per-connection reply ring, announced at hello.
    """

    scheme = "shm"
    needs_heartbeat = True

    def __init__(self, address: str, *, descriptor=None, lookup=None,
                 ring_bytes: int = DEFAULT_RING_BYTES):
        self._ring = ShmRing(ring_bytes)
        try:
            super().__init__(address, descriptor=descriptor, lookup=lookup)
        except (OSError, ServiceFailure):
            self._ring.close(unlink=True)
            raise

    def _hello_msg(self) -> dict:
        return {"op": "hello", "shm": True,
                "shm_bytes": self._ring.capacity}

    def _dump(self, tree) -> bytes:
        obs = self.obs
        if obs is None:
            return dump_pytree_shm(tree, self._ring)
        b0 = self._ring.bytes_written
        f0 = self._ring.inline_fallbacks
        data = dump_pytree_shm(tree, self._ring)
        obs.event("shm-ring", None, getattr(self, "service_id", "?"),
                  self._ring.bytes_written - b0,
                  self._ring.inline_fallbacks - f0)
        return data

    @property
    def shm_bytes_out(self) -> int:
        """Payload bytes memcpy'd into the request ring (vs crossing the
        socket — see ``payload_bytes_out`` for the frame-borne residue)."""
        return self._ring.bytes_written

    def close(self) -> None:
        super().close()
        self._ring.close(unlink=True)


class ShmTransport(Transport):
    scheme = "shm"

    def resolve(self, descriptor, lookup=None) -> ShmHandle | None:
        address = descriptor.endpoint.split("://", 1)[1]
        try:
            return ShmHandle(address, descriptor=descriptor, lookup=lookup)
        except (OSError, ServiceFailure):
            if lookup is not None:  # stale registration: drop it
                lookup.unregister(descriptor.service_id)
            return None


register_transport(ShmTransport())
