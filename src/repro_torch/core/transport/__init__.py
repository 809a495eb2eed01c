"""Pluggable farm transports.

``resolve_handle(descriptor, lookup=...)`` turns a registered endpoint
address into a :class:`ServiceHandle`; the layers above (control threads,
clients) only ever see the handle.  Importing this package registers the
in-process backend:

- ``inproc://`` — the live-object zero-copy backend (default).

The reference package's ``proc://``, ``shm://``, ``tcp://`` and
``sim://`` backends are not ported yet.
"""

from .base import (LivenessMonitor, ServiceHandle, Transport,  # noqa: F401
                   get_transport, register_transport, resolve_handle)
from .inproc import InProcessTransport, InProcHandle  # noqa: F401
