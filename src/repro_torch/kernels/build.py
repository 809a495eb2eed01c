"""Build and bind the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, under
``build/repro_torch_kernels/`` at the root of the checkout when the
package runs from one (``src/repro_torch``), else under
``~/.cache/repro_torch_kernels/``, and loaded with ``ctypes``.  A library's file name carries a hash of its sources and
flags, so an edited source is rebuilt, never served stale.  Nothing here
runs at import: the first CUDA call (or :func:`build_all`) builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"


def _build_dir() -> Path:
    src = Path(__file__).resolve().parents[2]
    if src.name == "src" and (src.parent / "pyproject.toml").is_file():
        return src.parent / "build" / "repro_torch_kernels"
    return Path.home() / ".cache" / "repro_torch_kernels"


BUILD_DIR = _build_dir()
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the
    toolkit's conventional install location."""
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = [Path(cuda_home, "bin", "nvcc")] if cuda_home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on the PATH")


class CudaKernel:
    """One kernel's shared library, its C entry point and launch count.

    ``launch(*args)`` calls the entry point (which launches on the stream
    passed as its last argument and returns ``cudaGetLastError()``),
    raises if that is not 0, and counts the launch.  ``launches`` counts
    every kernel launch made through this object."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        self._lib = None
        self._lock = threading.Lock()

    @property
    def name(self) -> str:
        return self.source.stem

    def library_path(self) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for f in sorted(CSRC.glob("*.cuh")) + [self.source]:
            h.update(f.name.encode())
            h.update(f.read_bytes())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    def start_build(self) -> subprocess.Popen | None:
        """Start ``nvcc`` for this library unless it is built already;
        returns the running process (see :func:`build_all`)."""
        lib = self.library_path()
        if lib.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
             str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        proc.tmp, proc.lib = tmp, lib
        return proc

    def _loaded(self):
        with self._lock:
            if self._fn is None:
                _finish_builds([self.start_build()])
                lib = ctypes.CDLL(str(self.library_path()))
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
                lib.repro_cuda_error_string.restype = ctypes.c_char_p
                self._lib, self._fn = lib, fn
            return self._fn

    def launch(self, *args) -> None:
        err = self._loaded()(*args)
        if err != 0:
            msg = self._lib.repro_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.symbol} failed to launch: CUDA error "
                               f"{err} ({msg})")
        with self._lock:
            self.launches += 1


def _finish_builds(procs, seconds=None, start=None) -> dict[str, str]:
    """Wait for the ``nvcc`` processes; returns each library's compiler
    output (registers, spills) by file name, and puts into ``seconds``
    (when given) each library's seconds from ``start`` to its end."""
    procs = [p for p in procs if p is not None]
    outs = {}

    def wait(proc):
        outs[proc] = proc.communicate()[0]
        if seconds is not None:
            seconds[proc.lib.name] = time.perf_counter() - start

    waiters = [threading.Thread(target=wait, args=(p,)) for p in procs]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    logs, failures = {}, []
    for proc in procs:
        log = outs[proc]
        logs[proc.lib.name] = log
        if proc.returncode != 0:
            proc.tmp.unlink(missing_ok=True)
            failures.append(f"{proc.lib.name}:\n{log}")
            continue
        os.replace(proc.tmp, proc.lib)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return logs


def build_all(kernels, seconds=None) -> dict[str, str]:
    """Build every library that is not built yet, one ``nvcc`` per
    source, all started together; returns the compiler output of each
    library built, and puts each one's build seconds into ``seconds``
    when given."""
    start = time.perf_counter()
    return _finish_builds([k.start_build() for k in kernels], seconds, start)
