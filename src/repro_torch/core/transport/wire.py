"""The farm wire protocol: framing and payload serialization.

Every message between a client-side :class:`~repro_torch.core.transport.
base.ServiceHandle` and a worker is one **frame**: a 4-byte big-endian
length followed by a msgpack-encoded envelope (a ``dict`` with an ``op``
field).  Task payloads and results travel inside envelopes as opaque
``bytes`` produced by :func:`dump_pytree` — tensors on any device are
copied to compact CPU tensors on the way out (that device→host copy *is*
the real serialization cost the in-process backend never pays) and
pickled as tensors, which carries every dtype, bf16 included (numpy has
no bf16); numpy and Python leaves pickle as-is.  The receiving program
moves tensors to its own device.

Programs cross the wire once per (connection, program): ``fn`` is
cloudpickled (lambdas and closures included), the rest of the ``Program``
constructor arguments ride alongside.  msgpack and cloudpickle are both
optional — without msgpack the envelope falls back to pickle (same frame
layout), without cloudpickle a program reaches a ``proc`` worker only by
reference: an importable module-level function, or an instance of an
importable class.
"""

from __future__ import annotations

import io
import pickle
import socket
import struct
from typing import Any

import torch
from torch.utils import _pytree as pytree

from ..errors import TransportError

try:  # optional: nicer/faster envelopes, but pickle works too
    import msgpack as _msgpack
except ImportError:  # pragma: no cover - exercised only on bare installs
    _msgpack = None

try:  # optional: required only to ship lambdas/closures to proc workers
    import cloudpickle as _cloudpickle
except ImportError:  # pragma: no cover - exercised only on bare installs
    _cloudpickle = None

# A frame larger than this is a protocol error, not a big payload: the
# farm model is many small tasks, and an unbounded length prefix would let
# a corrupt frame OOM the reader.
MAX_FRAME_BYTES = 1 << 30

_LEN = struct.Struct(">I")


def pack_envelope(msg: dict) -> bytes:
    if _msgpack is not None:
        return b"M" + _msgpack.packb(msg, use_bin_type=True)
    return b"P" + pickle.dumps(msg)


def unpack_envelope(data: bytes) -> dict:
    if not data:
        # a zero-length frame is a framing bug on the peer, not an unknown
        # tag: say so (the b'' "tag" error sent people hunting a codec
        # problem that never existed)
        raise TransportError("zero-length frame")
    tag, body = data[:1], data[1:]
    if tag == b"M":
        if _msgpack is None:
            raise TransportError("peer sent a msgpack frame but msgpack "
                                 "is not installed here")
        try:
            msg = _msgpack.unpackb(body, raw=False)
        except Exception as e:
            raise TransportError(f"corrupt msgpack envelope: {e}") from e
    elif tag == b"P":
        try:
            msg = pickle.loads(body)
        except Exception as e:
            raise TransportError(f"corrupt pickle envelope: {e}") from e
    else:
        raise TransportError(f"unknown envelope tag {tag!r}")
    if not isinstance(msg, dict):
        raise TransportError(
            f"envelope decoded to {type(msg).__name__}, expected dict")
    return msg


def send_frame(sock: socket.socket, msg: dict) -> None:
    data = pack_envelope(msg)
    if len(data) > MAX_FRAME_BYTES:
        raise TransportError(f"frame of {len(data)} bytes exceeds cap")
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    """Read exactly n bytes; None on clean EOF at a frame boundary."""
    buf = io.BytesIO()
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            return None if got == 0 else b""
        buf.write(chunk)
        got += len(chunk)
    return buf.getvalue()


def recv_frame(sock: socket.socket) -> dict | None:
    """One envelope, or None on clean EOF (peer closed between frames)."""
    header = _recv_exact(sock, _LEN.size)
    if header is None:
        return None
    if header == b"":
        raise TransportError("connection died mid-frame header")
    (n,) = _LEN.unpack(header)
    if n == 0:
        # the `if not data and n` guard below would otherwise wave an
        # empty body through to unpack_envelope(b"")
        raise TransportError("zero-length frame")
    if n > MAX_FRAME_BYTES:
        raise TransportError(f"peer announced a {n}-byte frame (cap "
                             f"{MAX_FRAME_BYTES})")
    data = _recv_exact(sock, n)
    if not data:
        raise TransportError("connection died mid-frame body")
    return unpack_envelope(data)


# --------------------------------------------------------------------- #
# pytree leaf serialization
# --------------------------------------------------------------------- #
def _to_host(leaf: Any) -> Any:
    """Tensors on any device -> compact CPU tensors; numpy and Python
    leaves pass through.  Compact matters: a pickled tensor carries its
    whole storage, so a view (a slice of a larger batch) is copied out
    first — otherwise every task would ship the whole batch."""
    if not isinstance(leaf, torch.Tensor):
        return leaf
    t = leaf.detach().cpu()
    if (not t.is_contiguous() or t.storage_offset() != 0
            or t.untyped_storage().nbytes() != t.numel() * t.element_size()):
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def dump_pytree(tree: Any) -> bytes:
    """Payload/result pytree -> bytes.  Tensors become compact CPU tensors
    (the receiving program moves them to its own device)."""
    return pickle.dumps(pytree.tree_map(_to_host, tree),
                        protocol=pickle.HIGHEST_PROTOCOL)


def load_pytree(data: bytes) -> Any:
    return pickle.loads(data)


# --------------------------------------------------------------------- #
# program serialization
# --------------------------------------------------------------------- #
def dump_program(program) -> dict:
    """Serializable description of a Program (see ``load_program``).

    ``uid`` is the *client's* uid — the worker keys its program table on
    it, so client-side program-cache identity survives the hop."""
    if _cloudpickle is not None:
        fn_bytes = _cloudpickle.dumps(program.fn)
    else:
        try:
            fn_bytes = pickle.dumps(program.fn)
        except Exception as e:  # lambda/closure without cloudpickle
            raise TransportError(
                f"cannot serialize program {program.name!r} for a proc "
                f"worker without cloudpickle: {e}") from e
    return {"uid": program.uid, "name": program.name, "fn": fn_bytes,
            "host": program.host}


def load_program(desc: dict):
    from ..skeletons import Program  # local: keep wire.py a leaf module

    fn = pickle.loads(desc["fn"])  # cloudpickle output loads via pickle
    return Program(fn, name=desc["name"], host=desc["host"])
