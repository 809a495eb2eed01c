"""Multi-host NoW launcher: workers that discover the farm over TCP.

Where :class:`repro_torch.launch.now.NowPool` registers its workers into
the client's in-process ``LookupService``, :class:`TcpPool` stands up (or
joins) a network-reachable :class:`~repro_torch.core.transport.tcp.
LookupServer` and spawns workers that **register themselves** through a
:class:`~repro_torch.core.transport.tcp.RemoteLookup` — exactly what a
worker on another machine would do, so one host running

    python -m repro_torch.launch.tcp --worker --lookup <host>:<port>

joins a farm whose client lives anywhere.  The client side of the pool
is itself a ``RemoteLookup``, so discovery, subscription-driven elastic
recruitment, and the stale-registration cleanup all cross the network
too; the data plane is the ``tcp://`` handle (proc's wire protocol).

Fault story: SIGKILLing a worker leaves a stale registration that
recruiters clean up on first contact, while the heartbeat
(`LivenessMonitor`) expires its leases; dropping or restarting the
lookup server exercises the reconnect-with-backoff + owned-descriptor
replay path in ``RemoteLookup``.

Each worker is a fresh interpreter, so on the card each holds a CUDA
context of its own.  Workers run on ``device``: ``None`` is the card
(``cuda:0``), and the CPU is used only when asked for (``device="cpu"``);
a worker asked for the card on a machine without one exits with
:func:`repro_torch.device.resolve_device`'s error instead of serving on
the CPU, and then never registers.  Programs reach workers as they do on
``proc://`` (see :mod:`repro_torch.launch.now`).

Usage::

    with TcpPool(4, task_delay_s=0.01, device="cpu") as pool:
        BasicClient(program, None, tasks, out, lookup=pool.lookup).compute()
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Sequence

from .now import _PORT_PREFIX, NowPool, _watchdog


@dataclass
class TcpWorker:
    index: int
    service_id: str
    proc: subprocess.Popen
    port: int
    host: str = "127.0.0.1"
    descriptor: object = field(repr=False, default=None)

    @property
    def address(self) -> str:
        return f"tcp://{self.host}:{self.port}"

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None


class TcpPool:
    """Spawn self-registering ``tcp://`` workers around a LookupServer."""

    def __init__(self, n_workers: int, *, host: str = "127.0.0.1",
                 lookup_address: str | None = None,
                 task_delay_s: float = 0.0,
                 speed_factors: Sequence[float] | None = None,
                 service_prefix: str = "tcp",
                 startup_timeout_s: float = 120.0,
                 keepalive_s: float = 0.25, device=None):
        from repro_torch.core.transport.tcp import LookupServer, RemoteLookup

        self.device = None if device is None else str(device)
        if lookup_address is None:
            self.server: LookupServer | None = LookupServer(host=host)
            self.lookup_address = self.server.address
        else:  # join a farm whose lookup lives elsewhere
            self.server = None
            self.lookup_address = lookup_address
        #: the client's view of discovery — a network proxy, never the
        #: server-side object, so the whole path is exercised even when
        #: server and client share a host
        self.lookup = RemoteLookup(self.lookup_address)
        self.workers: list[TcpWorker] = []
        try:
            for i in range(n_workers):
                sf = (speed_factors[i] if speed_factors else 1.0)
                self.workers.append(self._spawn(
                    f"{service_prefix}{i}", i, host, task_delay_s, sf,
                    startup_timeout_s, keepalive_s))
            # workers register themselves after their (slow) torch import
            # and, on the card, their CUDA context; wait so the pool is
            # usable the moment the constructor returns
            if n_workers:
                self._wait_registered(n_workers, startup_timeout_s)
        except Exception:
            self.shutdown()
            raise

    def _wait_registered(self, n: int, timeout_s: float) -> None:
        """Wait for ``n`` registrations, in one-second slices so that a
        worker that exits first (a card asked for on a machine without
        one) fails the pool at once rather than at the timeout."""
        deadline = time.monotonic() + timeout_s
        while not self.lookup.wait_for_services(
                n, timeout_s=min(1.0, max(0.0, deadline - time.monotonic()))):
            dead = {w.service_id: w.proc.poll() for w in self.workers
                    if not w.alive}
            if dead or time.monotonic() >= deadline:
                raise RuntimeError(
                    f"only {len(self.lookup)} of {n} tcp workers registered "
                    f"within {timeout_s}s; exited (exit codes): {dead}")

    # ------------------------------------------------------------- #
    def _spawn(self, service_id: str, index: int, host: str,
               task_delay_s: float, speed_factor: float,
               startup_timeout_s: float, keepalive_s: float) -> TcpWorker:
        import repro_torch

        # namespace-package safe: __file__ is None, __path__ is not
        src_dir = os.path.dirname(
            os.path.abspath(list(repro_torch.__path__)[0]))
        env = dict(os.environ)
        env["PYTHONPATH"] = src_dir + os.pathsep + env.get("PYTHONPATH", "")
        cmd = [sys.executable, "-m", "repro_torch.launch.tcp", "--worker",
               "--service-id", service_id,
               "--host", host,
               "--lookup", self.lookup_address,
               "--task-delay-s", str(task_delay_s),
               "--speed-factor", str(speed_factor),
               "--keepalive-s", str(keepalive_s),
               "--parent-pid", str(os.getpid())]
        if self.device is not None:
            cmd += ["--device", self.device]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, env=env,
                                text=True)
        port = NowPool._wait_for_port(proc, startup_timeout_s)
        return TcpWorker(index, service_id, proc, port, host)

    def scheduler(self, **cfg):
        """A multi-tenant :class:`repro_torch.farm.FarmScheduler` whose
        pool spans the network lookup."""
        from repro_torch.farm import FarmScheduler

        return FarmScheduler(self.lookup, **cfg)

    def executor(self, program, **knobs):
        from repro_torch.core.futures import FarmExecutor

        return FarmExecutor(program, lookup=self.lookup, **knobs)

    # ------------------------------------------------------------- #
    def kill(self, index: int, sig: int = signal.SIGKILL) -> None:
        """SIGKILL a live worker — it never says goodbye, its lookup
        registration goes stale, and its leases expire via heartbeat."""
        worker = self.workers[index]
        if worker.alive:
            os.kill(worker.proc.pid, sig)

    def shutdown(self, *, timeout_s: float = 5.0) -> None:
        from repro_torch.core.errors import TransportError

        for worker in self.workers:  # best-effort: don't leave stale ads
            try:
                self.lookup.unregister(worker.service_id)
            except TransportError:
                break  # lookup already gone; resolve-time cleanup handles it
        for worker in self.workers:
            if worker.alive:
                worker.proc.terminate()
        for worker in self.workers:
            try:
                worker.proc.wait(timeout_s)
            except subprocess.TimeoutExpired:
                worker.proc.kill()
                worker.proc.wait(timeout_s)
            if worker.proc.stdout is not None:
                worker.proc.stdout.close()
        self.lookup.close()
        if self.server is not None:
            self.server.close()

    def __enter__(self) -> "TcpPool":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def __len__(self) -> int:
        return len(self.workers)


# --------------------------------------------------------------------- #
# worker entry point
# --------------------------------------------------------------------- #
def worker_main(args: argparse.Namespace) -> int:
    import socket

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((args.host, args.port))
    srv.listen(8)
    # announce the port before the heavyweight imports (launcher UX);
    # registration happens after them, via the network lookup
    print(f"{_PORT_PREFIX}{srv.getsockname()[1]}", flush=True)
    if args.parent_pid:
        threading.Thread(target=_watchdog, args=(args.parent_pid,),
                         daemon=True).start()

    from repro_torch.core.service import Service
    from repro_torch.core.transport.proc import ServiceWorker
    from repro_torch.core.transport.tcp import RemoteLookup

    port = srv.getsockname()[1]
    lookup = RemoteLookup(args.lookup, keepalive_s=args.keepalive_s)
    # resolve_device raises (and the worker exits before it registers)
    # when the card is asked for and absent: a card worker never serves
    # on the CPU
    service = Service(lookup, service_id=args.service_id, device=args.device,
                      task_delay_s=args.task_delay_s,
                      speed_factor=args.speed_factor,
                      advertise=f"tcp://{args.host}:{port}",
                      capabilities={"transport": "tcp",
                                    "pid": os.getpid()})
    # Algorithm 2 line 3, finally across the machine boundary: register
    # into the (remote) lookup, then wait for requests.  RemoteLookup
    # owns this registration — after any lookup outage it reconnects
    # with backoff and re-registers (the flaky-registration fault path).
    service.start()
    ServiceWorker(service, srv).serve_forever()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.tcp",
        description="JJPF multi-host NoW worker (see TcpPool for the "
                    "launcher; point --lookup at any reachable "
                    "LookupServer to join its farm)")
    ap.add_argument("--worker", action="store_true",
                    help="run as a farm worker process")
    ap.add_argument("--service-id", default=None)
    ap.add_argument("--host", default="127.0.0.1",
                    help="address to bind AND advertise (use a "
                         "network-reachable address for multi-host runs)")
    ap.add_argument("--port", type=int, default=0,
                    help="TCP port (0 = ephemeral, printed on stdout)")
    ap.add_argument("--lookup", required=False, default=None,
                    help="host:port of the LookupServer to register with")
    ap.add_argument("--task-delay-s", type=float, default=0.0)
    ap.add_argument("--speed-factor", type=float, default=1.0)
    ap.add_argument("--keepalive-s", type=float, default=0.25,
                    help="lookup keepalive interval (0 disables; the "
                         "keepalive is what notices a lookup restart and "
                         "triggers re-registration)")
    ap.add_argument("--parent-pid", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the worker's device: the card (cuda:0) by "
                         "default, 'cpu' only when asked for")
    args = ap.parse_args(argv)
    if not args.worker:
        ap.error("this module is the worker entry point; pass --worker "
                 "(workers are normally spawned by "
                 "repro_torch.launch.tcp.TcpPool)")
    if not args.lookup:
        ap.error("--lookup host:port is required for a tcp worker")
    return worker_main(args)


if __name__ == "__main__":
    raise SystemExit(main())
