"""The paper's three examples on the port, held against the reference's on
the same inputs, on the CPU:

- ``examples/torch_fractal_farm.py`` (Mandelbrot tiles over fast, slow and
  flaky services): every tile against the reference's ``mandelbrot_tile``
  (``examples/fractal_farm.py``, loaded with ``importlib``), pixel by pixel;
- ``examples/torch_pagerank_farm.py`` (block mat-vecs over 3 services,
  one dying after 5 tasks): the iterations, the ranks within 1e-6 and the
  top-5 against the reference example's own run;
- ``examples/torch_quickstart.py``: its ``results``, ``pipeline``,
  ``batched``, ``futures`` and ``tenants`` lines over ``inproc`` and over
  ``proc`` workers on the route a bare install takes (no ``msgpack``, no
  ``cloudpickle``, as on the card's machine), equal to each other and to
  the reference quickstart's.

Each port example runs as a subprocess with ``--device cpu`` and must
import neither ``jax`` nor ``repro``.
"""

import contextlib
import importlib.util
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
QUICKSTART_LINES = ("results", "pipeline", "batched", "futures", "tenants")


@pytest.fixture(autouse=True)
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _run(example, *args, pythonpath=()):
    """Run ``examples/<example>`` as ``__main__`` with ``args`` (and
    ``pythonpath`` before ``src``), then fail if the process imported jax
    or the reference package.  Returns its standard output."""
    path = str(EXAMPLES / example)
    code = ("import runpy, sys\n"
            f"sys.argv = [{path!r}] + {list(args)!r}\n"
            f"runpy.run_path({path!r}, run_name='__main__')\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([*map(str, pythonpath), str(ROOT / "src")]),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.rstrip().endswith("OK"), proc.stdout
    return proc.stdout


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(out, keys):
    """{key: the rest of the line} for each line that starts with a key."""
    found = {}
    for line in out.splitlines():
        key, _, rest = line.partition(":")
        if key.strip() in keys:
            found[key.strip()] = rest.strip()
    assert set(found) == set(keys), out
    return found


# --------------------------------------------------------------------- #
# fractal
# --------------------------------------------------------------------- #
def test_fractal_tiles_match_the_reference():
    """All 16 tiles of the 256 x 256 image through the port's tile program
    and the reference's on the same origins.  5 of 65,536 pixels differ on
    this CPU (torch 2.13, jax 0.9): XLA fuses the real part of z * z into
    one multiply-add, PyTorch rounds the product first, and on the set's
    chaotic boundary that moves a late escape by one step (42 or more).
    The count and the kind of difference are held; then the example's own
    run over the faulty farm gives the reference image's interior fraction
    and ASCII preview."""
    import jax.numpy as jnp

    ref = _load(EXAMPLES / "fractal_farm.py", "reference_fractal_farm")
    port = _load(EXAMPLES / "torch_fractal_farm.py", "port_fractal_farm")
    assert (port.SIZE, port.TILE, port.MAX_ITER) == (ref.SIZE, ref.TILE, ref.MAX_ITER)
    tiles_p, tiles_r, differ = [], [], []
    for task in port.tasks():
        got = port.mandelbrot_tile(task)
        want = ref.mandelbrot_tile({"x0": jnp.asarray(float(task["x0"])),
                                    "y0": jnp.asarray(float(task["y0"]))})
        a, b = got["tile"].numpy(), np.asarray(want["tile"])
        assert a.dtype == b.dtype == np.int32 and a.shape == b.shape == (port.TILE,) * 2
        tiles_p.append(got)
        tiles_r.append({"x0": task["x0"], "y0": task["y0"], "tile": torch.tensor(b)})
        differ += [(int(x), int(y)) for x, y in zip(a[a != b], b[a != b])]
    assert len(differ) == 5, differ
    assert all(abs(x - y) == 1 and min(x, y) >= 42 for x, y in differ), differ
    img_r = port.assemble(tiles_r)
    assert (port.assemble(tiles_p) != img_r).sum() == len(differ)

    out = _run("torch_fractal_farm.py", "--device", "cpu")
    assert f"interior fraction {(img_r == 0).mean():.3f}" in out
    assert "\n".join(port.preview(img_r)) in out
    assert "reschedules:" in out and "'flaky': 2" in out


# --------------------------------------------------------------------- #
# pagerank
# --------------------------------------------------------------------- #
class _RecordArgsort:
    """numpy for the reference example's module, with ``argsort`` recording
    its argument: the example sorts ``-x``, its final ranks."""

    def __init__(self):
        self.seen = []

    def __getattr__(self, name):
        return getattr(np, name)

    def argsort(self, a, *args, **kw):
        self.seen.append(np.asarray(a))
        return np.argsort(a, *args, **kw)


def test_pagerank_matches_the_reference():
    ref = _load(EXAMPLES / "pagerank_farm.py", "reference_pagerank_farm")
    rec = _RecordArgsort()
    ref.np = rec
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        ref.main()
    out_r = printed.getvalue()
    x_r = -rec.seen[-1]

    port = _load(EXAMPLES / "torch_pagerank_farm.py", "port_pagerank_farm")
    assert (port.N, port.BLOCKS, port.DAMP) == (ref.N, ref.BLOCKS, ref.DAMP)
    from repro_torch.core import LookupService

    lookup = LookupService()
    services = port.start_services(lookup, torch.device("cpu"))
    x, iters, _ = port.pagerank(port.column_blocks("cpu"), lookup, torch.device("cpu"))
    assert not services[0].alive
    assert f"converged in {iters} iterations" in out_r
    np.testing.assert_allclose(x.numpy(), x_r, atol=1e-6, rtol=0)
    top = np.argsort(-x.numpy())[:5]
    assert top.tolist() == np.argsort(-x_r)[:5].tolist()

    out = _run("torch_pagerank_farm.py", "--device", "cpu")
    assert f"converged in {iters} iterations" in out
    assert _lines(out, ("top-5 nodes",)) == _lines(out_r, ("top-5 nodes",))


# --------------------------------------------------------------------- #
# quickstart
# --------------------------------------------------------------------- #
@pytest.fixture
def bare_install(tmp_path):
    """A directory that, first on PYTHONPATH, hides msgpack and cloudpickle
    from a process and the workers it starts (the card's machine has
    neither)."""
    for name in ("msgpack", "cloudpickle"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(
            f'raise ImportError("{name} is not installed here")\n')
    return tmp_path


def test_quickstart_matches_the_reference_over_inproc_and_proc(bare_install):
    """The five result lines of the port's quickstart in process and over 3
    ``proc://`` workers without cloudpickle (the programs, the pipeline's
    fused one too, reach the workers by reference), and of the reference's
    quickstart in process."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, str(EXAMPLES / "quickstart.py")], env=env,
                         cwd=ROOT, capture_output=True, text=True, timeout=180)
    assert ref.returncode == 0, ref.stdout + ref.stderr
    want = _lines(ref.stdout, QUICKSTART_LINES)
    inproc = _run("torch_quickstart.py", "--device", "cpu")
    proc = _run("torch_quickstart.py", "--device", "cpu", "--transport", "proc",
                pythonpath=(bare_install,))
    assert _lines(inproc, QUICKSTART_LINES) == want
    assert _lines(proc, QUICKSTART_LINES) == want
    assert "proc://" not in inproc and "qs0" in proc  # the workers' service ids


def test_quickstart_traces_every_farm(tmp_path):
    from repro_torch.obs.export import validate_chrome_trace

    trace = tmp_path / "trace.json"
    out = _run("torch_quickstart.py", "--device", "cpu", "--trace", str(trace))
    assert "farm-top" in out and f"trace   : wrote {trace}" in out
    summary = validate_chrome_trace(str(trace))
    assert summary["service_tracks"] >= 2, summary


def test_composed_program_pickles_by_reference():
    """The normal form's fused program holds module-level stage functions
    and pickles without cloudpickle (it was a closure, which a ``proc``
    worker could take only by value)."""
    import operator
    import pickle
    from functools import partial

    from repro_torch.core import Farm, Pipe, Program, Seq, normalize

    skel = Pipe(Farm(Seq(Program(partial(operator.add, 10.0), name="shift"))),
                Seq(Program(partial(operator.mul, 2.0), name="scale")))
    fused = normalize(skel).worker.program
    again = pickle.loads(pickle.dumps(fused.fn))
    assert fused.name == "shift∘scale" and float(again(torch.tensor(1.0))) == 22.0
