"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's (``repro.launch.roofline``).

- ``model_flops`` and ``analytic_memory_bytes`` equal the reference's
  exactly for every arch x shape x mesh record (the same arithmetic on the
  same configs).
- ``analyze_cell`` and ``to_markdown`` equal the reference's on the same
  records (the reference's dry-run keys beside the port's) once the test
  process's ``repro.launch.roofline.HW`` holds the port's H100 constants,
  NVLink in place of the reference's link; ``advice`` speaks of each
  package's own tools and is left out of the comparison.
- The analysis modules (dry run, roofline, op stats) import neither jax
  nor the reference package, and the roofline's command line runs on dry
  run records.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.configs as jcfgs
import repro.launch.roofline as jroof
import repro_torch.configs as tcfgs
import repro_torch.launch.roofline as troof
from repro.models.registry import SHAPES as JSHAPES
from repro_torch.launch.mesh import HW
from repro_torch.models.registry import SHAPES

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single": 256, "multi": 512}


def _records():
    """Every arch x shape x mesh record the roofline reads, with made-up
    per-device figures under both packages' keys."""
    out = []
    for i, arch in enumerate(tcfgs.ARCH_IDS):
        total, active = tcfgs.get(arch).param_counts()
        for j, shape in enumerate(SHAPES):
            for mesh, n in MESHES.items():
                flops = 1.0e12 * (1 + i) * (1 + j) * (2 if mesh == "multi" else 1)
                nbytes = 3.3e11 * (2 + j) / (1 + i)
                wire = 0.0 if (i + j) % 5 == 0 else 7.7e9 * (1 + j) / (1 + i)
                peak = int(2.1e9 * (1 + i) * (1 + j))
                out.append({
                    "arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
                    "n_chips": n, "params_total": total, "params_active": active,
                    "dot_flops_per_device": flops, "hlo_dot_flops_per_device": flops,
                    "bytes_accessed_per_device": nbytes, "hlo_bytes_accessed_per_device": nbytes,
                    "memory": {"peak_bytes_per_device": peak},
                    "collectives": {"count": {"all-gather": float(i + j)},
                                    "total_wire_bytes": wire}})
    return out


def test_the_ports_archs_and_shapes_are_the_references():
    assert list(tcfgs.ARCH_IDS) == list(jcfgs.ARCH_IDS)
    assert {k: (v.kind, v.seq_len, v.global_batch) for k, v in SHAPES.items()} == \
        {k: (v.kind, v.seq_len, v.global_batch) for k, v in JSHAPES.items()}


@pytest.mark.parametrize("arch", tcfgs.ARCH_IDS)
def test_model_flops_and_analytic_memory_are_the_references(arch):
    recs = [r for r in _records() if r["arch"] == arch]
    assert len(recs) == len(SHAPES) * len(MESHES)
    for rec in recs:
        assert troof.model_flops(rec) == jroof.model_flops(rec), rec["shape"]
        assert troof.analytic_memory_bytes(rec) == jroof.analytic_memory_bytes(rec), (
            rec["shape"], rec["mesh"])


@pytest.fixture
def h100_reference(monkeypatch):
    """The reference's roofline on the port's H100 constants."""
    monkeypatch.setattr(jroof, "HW", {"peak_flops_bf16": HW["peak_flops_bf16"],
                                      "hbm_bandwidth": HW["hbm_bandwidth"],
                                      "hbm_bytes": HW["hbm_bytes"],
                                      "ici_link_bandwidth": HW["nvlink_bandwidth"]})
    return jroof


def test_analyze_cell_and_markdown_are_the_references_on_h100_constants(h100_reference):
    recs = _records() + [{"arch": "qwen3_1p7b", "shape": "train_4k", "mesh": "single",
                          "status": "error"}]
    got = [troof.analyze_cell(r) for r in recs]
    want = [h100_reference.analyze_cell(r) for r in recs]
    assert got[-1] is None and want[-1] is None
    doms = set()
    for g, w in zip(got[:-1], want[:-1]):
        assert g.pop("advice") and w.pop("advice")
        assert g == w
        doms.add(g["dominant"])
    assert doms == {"compute", "memory", "collective"}
    for mesh in MESHES:
        md = troof.to_markdown(got, mesh)
        assert md == h100_reference.to_markdown(want, mesh)
        assert md.count("\n") == 2 + len(SHAPES) * len(tcfgs.ARCH_IDS)


def test_the_analysis_modules_import_no_jax_and_the_roofline_reads_records(tmp_path):
    rec = next(r for r in _records() if r["shape"] == "decode_32k")
    (tmp_path / "a.json").write_text(json.dumps(rec))
    (tmp_path / "b.json").write_text(json.dumps({"arch": rec["arch"], "shape": "long_500k",
                                                 "mesh": "single", "status": "skipped",
                                                 "reason": "pure full-attention arch"}))
    code = ("import sys\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.roofline\n"
            "import repro_torch.utils.op_stats\n"
            "from repro_torch.launch.roofline import main\n"
            f"main(['--dir', {str(tmp_path)!r}, '--json', {str(tmp_path / 'rows.json')!r}])\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'repro' or m.startswith('repro.'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "1 analyzed, 1 skipped" in proc.stdout
    assert "not timings" in proc.stdout and "256 cards" in proc.stdout
    rows = json.loads((tmp_path / "rows.json").read_text())
    assert [r["arch"] for r in rows] == [rec["arch"]]
