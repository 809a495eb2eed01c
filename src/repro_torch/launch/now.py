"""NoW launcher: a pool of farm workers, each its own OS process.

The paper ran services on a Network of Workstations discovered via Jini;
here :class:`NowPool` stands the network up locally — it spawns N worker
processes (``python -m repro_torch.launch.now --worker``), waits for each to
print its TCP port, and registers ``proc://127.0.0.1:<port>`` endpoint
descriptors into the client's ``LookupService``.  From there the normal
machinery takes over: recruitment resolves the address through the
transport registry, control threads speak the wire protocol, and killing
a worker (``NowPool.kill`` sends SIGKILL by default) is an *actual*
process death the lease/reschedule path has to absorb.

Workers print their port before importing torch, so pool startup is fast;
the first recruit blocks until the worker finishes importing (~seconds).
A ``--parent-pid`` watchdog makes workers exit if the launcher dies, so
crashed test runs don't leak processes.

Each worker is a fresh interpreter (``subprocess.Popen``, never a fork of
the launcher), so on the card each holds a CUDA context of its own and
runs its tasks on its own service stream.  Workers run on ``device``:
``None`` is the card (``cuda:0``), and the CPU is used only when asked
for (``device="cpu"``); a worker asked for the card on a machine without
one exits with :func:`repro_torch.device.resolve_device`'s error instead
of serving on the CPU.

A program reaches a worker by value when ``cloudpickle`` is installed,
and otherwise by reference (an importable module-level function, or an
instance of an importable class): the worker must be able to import its
module.  Workers get the launcher's ``PYTHONPATH`` with this package's
``src`` directory in front; put the directory of any other module a
program lives in on ``PYTHONPATH`` before the pool starts.

Usage::

    with NowPool(4, lookup, task_delay_s=0.01, device="cpu") as pool:
        BasicClient(program, None, tasks, out, lookup=lookup).compute()
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import threading
from dataclasses import dataclass, field
from typing import Sequence

_PORT_PREFIX = "JJPF_WORKER_PORT="


@dataclass
class NowWorker:
    index: int
    service_id: str
    proc: subprocess.Popen
    port: int
    scheme: str = "proc"
    descriptor: object = field(repr=False, default=None)

    @property
    def address(self) -> str:
        return f"{self.scheme}://127.0.0.1:{self.port}"

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None


class NowPool:
    """Spawn, register, kill, and reap ``proc://`` farm workers."""

    def __init__(self, n_workers: int, lookup=None, *,
                 task_delay_s: float = 0.0,
                 speed_factors: Sequence[float] | None = None,
                 service_prefix: str = "now",
                 startup_timeout_s: float = 120.0,
                 transport: str = "proc", device=None):
        from repro_torch.core.discovery import ServiceDescriptor

        if transport not in ("proc", "shm"):
            raise ValueError(f"NowPool transport must be 'proc' or 'shm', "
                             f"got {transport!r}")
        self.lookup = lookup
        self.transport = transport
        self.device = None if device is None else str(device)
        self.workers: list[NowWorker] = []
        try:
            for i in range(n_workers):
                sf = (speed_factors[i] if speed_factors else 1.0)
                worker = self._spawn(f"{service_prefix}{i}", i,
                                     task_delay_s, sf, startup_timeout_s)
                worker.scheme = transport
                worker.descriptor = ServiceDescriptor(
                    worker.service_id, worker.address,
                    {"n_devices": 1, "speed_factor": sf,
                     "transport": transport, "pid": worker.proc.pid,
                     "device": self.device or "cuda"})
                self.workers.append(worker)
        except Exception:
            self.shutdown()
            raise
        if self.lookup is not None:
            for worker in self.workers:
                self.lookup.register(worker.descriptor)

    # ------------------------------------------------------------- #
    def _spawn(self, service_id: str, index: int, task_delay_s: float,
               speed_factor: float, startup_timeout_s: float) -> NowWorker:
        import repro_torch

        # namespace-package safe: __file__ is None, __path__ is not
        src_dir = os.path.dirname(
            os.path.abspath(list(repro_torch.__path__)[0]))
        env = dict(os.environ)
        env["PYTHONPATH"] = src_dir + os.pathsep + env.get("PYTHONPATH", "")
        cmd = [sys.executable, "-m", "repro_torch.launch.now", "--worker",
               "--service-id", service_id,
               "--task-delay-s", str(task_delay_s),
               "--speed-factor", str(speed_factor),
               "--transport", self.transport,
               "--parent-pid", str(os.getpid())]
        if self.device is not None:
            cmd += ["--device", self.device]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, env=env,
                                text=True)
        port = self._wait_for_port(proc, startup_timeout_s)
        return NowWorker(index, service_id, proc, port)

    @staticmethod
    def _wait_for_port(proc: subprocess.Popen, timeout_s: float) -> int:
        got: dict = {}
        ready = threading.Event()

        def reader():  # keeps draining stdout forever (pipe never fills)
            for line in proc.stdout:
                line = line.strip()
                if line.startswith(_PORT_PREFIX) and not ready.is_set():
                    got["port"] = int(line[len(_PORT_PREFIX):])
                    ready.set()
            ready.set()  # EOF without a port: startup failure

        threading.Thread(target=reader, daemon=True).start()
        if not ready.wait(timeout_s) or "port" not in got:
            proc.kill()
            raise RuntimeError(
                f"worker pid {proc.pid} did not report a port within "
                f"{timeout_s}s (exit code {proc.poll()})")
        return got["port"]

    def scheduler(self, **cfg):
        """Shared-scheduler mode: a multi-tenant
        :class:`repro_torch.farm.FarmScheduler` owning this pool of worker
        processes — many jobs time-share the NoW instead of one
        BasicClient draining it.  The caller starts/stops it (use it as
        a context manager)."""
        from repro_torch.farm import FarmScheduler

        if self.lookup is None:
            raise RuntimeError("NowPool was built without a lookup")
        return FarmScheduler(self.lookup, **cfg)

    def executor(self, program, **knobs):
        """A :class:`repro_torch.core.FarmExecutor` over this pool of worker
        processes — the futures front-end of the same engine."""
        from repro_torch.core.futures import FarmExecutor

        if self.lookup is None:
            raise RuntimeError("NowPool was built without a lookup")
        return FarmExecutor(program, lookup=self.lookup, **knobs)

    # ------------------------------------------------------------- #
    def kill(self, index: int, sig: int = signal.SIGKILL) -> None:
        """Kill a live worker process — SIGKILL by default, because the
        fault-tolerance claim is about nodes that never say goodbye."""
        worker = self.workers[index]
        if worker.alive:
            os.kill(worker.proc.pid, sig)

    def shutdown(self, *, timeout_s: float = 5.0) -> None:
        if self.lookup is not None:
            for worker in self.workers:
                self.lookup.unregister(worker.service_id)
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

    def __enter__(self) -> "NowPool":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def __len__(self) -> int:
        return len(self.workers)


# --------------------------------------------------------------------- #
# worker entry point
# --------------------------------------------------------------------- #
def _watchdog(parent_pid: int) -> None:
    import time

    while True:
        time.sleep(1.0)
        try:
            os.kill(parent_pid, 0)
        except OSError:
            os._exit(2)  # launcher is gone; don't leak


def worker_main(args: argparse.Namespace) -> int:
    import socket

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((args.host, args.port))
    srv.listen(8)
    # announce the port BEFORE the heavyweight imports: the launcher can
    # register the endpoint while torch loads; early requests queue in the
    # listen backlog.
    print(f"{_PORT_PREFIX}{srv.getsockname()[1]}", flush=True)
    if args.parent_pid:
        threading.Thread(target=_watchdog, args=(args.parent_pid,),
                         daemon=True).start()

    from repro_torch.core.service import Service
    from repro_torch.core.transport.proc import ServiceWorker

    # resolve_device raises (and the worker exits) when the card is asked
    # for and absent: a card worker never serves on the CPU
    service = Service(None, service_id=args.service_id, device=args.device,
                      task_delay_s=args.task_delay_s,
                      speed_factor=args.speed_factor,
                      capabilities={"transport": args.transport,
                                    "pid": os.getpid()})
    ServiceWorker(service, srv).serve_forever()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.now",
        description="JJPF NoW worker process (see NowPool for the launcher)")
    ap.add_argument("--worker", action="store_true",
                    help="run as a farm worker process")
    ap.add_argument("--service-id", default=None)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="TCP port (0 = ephemeral, printed on stdout)")
    ap.add_argument("--task-delay-s", type=float, default=0.0)
    ap.add_argument("--speed-factor", type=float, default=1.0)
    ap.add_argument("--transport", default="proc",
                    help="advertised payload path ('proc' or 'shm'); the "
                         "worker itself negotiates shm per connection at "
                         "hello, so this only labels capabilities")
    ap.add_argument("--parent-pid", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the worker's device: the card (cuda:0) by "
                         "default, 'cpu' only when asked for")
    args = ap.parse_args(argv)
    if not args.worker:
        ap.error("this module is the worker entry point; pass --worker "
                 "(workers are normally spawned by "
                 "repro_torch.launch.now.NowPool)")
    return worker_main(args)


if __name__ == "__main__":
    raise SystemExit(main())
