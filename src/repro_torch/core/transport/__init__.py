"""Pluggable farm transports.

``resolve_handle(descriptor, lookup=...)`` turns a registered endpoint
address into a :class:`ServiceHandle`; the layers above (control threads,
clients, executors) only ever see the handle.  Importing this package
registers five backends:

- ``inproc://`` — the live-object zero-copy backend (default);
- ``proc://``   — one OS process per service, length-prefixed
  msgpack/pickle frames over TCP (workers spawned by
  :class:`repro_torch.launch.now.NowPool`, each with its own CUDA
  context on the card);
- ``shm://``    — proc's socket protocol, but payload leaves (numpy
  arrays and tensors) ride a same-host ``multiprocessing.shared_memory``
  ring (only descriptors cross the frame — the zero-copy fast path for
  cheap tasks);
- ``tcp://``    — real multi-host NoW: workers register with a
  network-reachable :class:`~repro_torch.core.transport.tcp.LookupServer`
  through a :class:`~repro_torch.core.transport.tcp.RemoteLookup` proxy
  (workers spawned by :class:`repro_torch.launch.tcp.TcpPool`, or started
  on any host with ``python -m repro_torch.launch.tcp --worker --lookup
  <host>:<port>``); the data plane is proc's wire protocol;
- ``sim://``    — deterministic simulated services on a virtual clock
  (clusters stood up by :class:`repro_torch.sim.SimCluster` /
  :class:`repro_torch.launch.sim.SimPool`), for reproducible scheduling
  and fault experiments.
"""

from .base import (LivenessMonitor, ServiceHandle, Transport,  # noqa: F401
                   get_transport, register_transport, resolve_handle)
from .inproc import InProcessTransport, InProcHandle  # noqa: F401
from .proc import ProcHandle, ProcTransport, ServiceWorker  # noqa: F401
from .shm import ShmHandle, ShmRing, ShmTransport  # noqa: F401
from .sim import SimHandle, SimTransport  # noqa: F401
from .tcp import (LookupServer, RemoteLookup, TcpHandle,  # noqa: F401
                  TcpTransport)
from .wire import (dump_program, dump_pytree, load_program,  # noqa: F401
                   load_pytree, recv_frame, send_frame)
