#!/usr/bin/env python3
"""The dry run held to the reference's: per-device FLOPs and wire bytes by
kind, the port beside the reference, on the ten cells of
``tests/test_torch_dryrun.py`` (its ``CELLS``, run as its fixture runs
them: fake ``cpu`` tensors over a fake process group for the port,
placeholder CPU devices for the reference, batch 8).

    PYTHONPATH=src python3 tools/dryrun_parity.py
    PYTHONPATH=src python3 tools/dryrun_parity.py --reference-collectives CELL

Prints one markdown table: each cell's FLOPs a device (the port's raw
count, its count with the named terms of ``_terms`` reckoned, the
reference's ``hlo_dot_flops_per_device``) and its wire bytes a device by
kind (reductions: all-reduce and reduce-scatter; all-gather; all-to-all;
collective-permute) and in all, port / reference, the port's with the
named terms of ``_wire_terms`` taken off where a cell has them; and its
argument and peak bytes a device, port / reference.  CPU only;
a few minutes.  With ``--reference-collectives`` it lists instead one
cell's ``ROWS`` largest collectives of each kind in the reference's
compiled HLO by wire bytes a device, grouped by result type and the JAX op
they come from, each group's wire bytes and runs ``analyze_hlo``'s: kind,
result type, op, how many run.
"""

import argparse
import math
import sys
import textwrap
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "tests"), str(ROOT / "src")]

import test_torch_dryrun as cells  # noqa: E402


ROWS = 4  # the reference's collectives listed of each kind, largest first
# the reference's compiled cell, its collectives grouped by result type and
# the JAX op they come from; each group's runs and wire bytes are
# ``analyze_hlo``'s, on the text with every other collective made a copy (a
# subprocess: the placeholder devices are set before jax starts)
REFERENCE_COLLECTIVES = """
import os
os.environ["DRYRUN_DEVICES"] = "{devices}"
import json, re
import repro.launch.dryrun as dr
from repro.launch.mesh import make_mesh
from repro.utils.hlo import analyze_hlo
arch, shape, mesh, over = {cell!r}
lowered, _ = dr.build_lowering(arch, shape, make_mesh(mesh, {axes!r}[-len(mesh):]),
                               batch_override={batch},
                               train_overrides={{"remat": True, **over}}
                               if shape.startswith("train") else over)
lines = lowered.compile().as_text().splitlines()
OP = re.compile(r"=\\s*(.+?)\\s+({kinds})(?:-start)?\\(")
keys = {{}}  # line -> (kind, result type, op)
for i, line in enumerate(lines):
    if m := OP.search(line):
        op = re.search(r'op_name="([^"]*)"', line)
        keys[i] = (m.group(2), m.group(1), op.group(1) if op else "")

copies = {{i: OP.sub(lambda m: "= " + m.group(1) + " copy(", lines[i]) for i in keys}}

def alone(key):
    text = "\\n".join(line if keys.get(i, key) == key else copies[i]
                       for i, line in enumerate(lines))
    st = analyze_hlo(text).collectives
    return [*key, st.wire_bytes[key[0]], st.count[key[0]]]

rows = sorted((alone(k) for k in set(keys.values())), key=lambda r: -r[3])
# the groups make up analyze_hlo's total, or one was missed
want = analyze_hlo("\\n".join(lines)).collectives.total_wire_bytes
assert abs(sum(r[3] for r in rows) - want) <= 1e-6 * want
kinds = {kinds!r}.split("|")
print("RESULT" + json.dumps([r for kind in kinds for r in [r for r in rows if r[0] == kind][:{rows}]]))
"""


def reference_collectives(name: str) -> None:
    cell = cells.CELLS[name]
    code = REFERENCE_COLLECTIVES.format(devices=math.prod(cell[2]), cell=cell, axes=cells.AXES,
                                        batch=cells.BATCH, rows=ROWS,
                                        kinds="|".join(op for ops in cells.KINDS.values()
                                                       for op in ops))
    rows = cells._result(cells._start(textwrap.dedent(code)), time.monotonic() + 900)
    print(f"{name}: the reference's {ROWS} largest collectives of each kind by wire bytes "
          "a device")
    print("| wire bytes | runs | kind | result | op |")
    print("| --- | --- | --- | --- | --- |")
    for kind, result, op, wire, n in rows:
        print(f"| {wire:.4g} | {n:g} | {kind} | `{result[:48]}` | `{op[-70:]}` |")


def _cpu() -> str:
    import platform

    try:
        with open("/proc/cpuinfo") as f:
            return next(line.split(":", 1)[1].strip() for line in f
                        if line.startswith("model name"))
    except (OSError, StopIteration):
        return platform.processor() or platform.machine()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reference-collectives", metavar="CELL", choices=list(cells.CELLS))
    args = ap.parse_args()
    if args.reference_collectives:
        reference_collectives(args.reference_collectives)
        return
    from importlib.metadata import version

    import torch

    runs = cells.run_all()
    kinds = list(cells.KINDS)
    print(f"torch {torch.__version__}, jax {version('jax')}, {_cpu()}, "
          f"{len(cells.CELLS)} cells, batch {cells.BATCH}")
    print("| cell | mesh | FLOPs port | reckoned | reference | "
          + " | ".join(f"{k} port / ref" for k in kinds) + " | total port / ref | "
          "arguments GiB port / ref | peak GiB port / ref |")
    print("| --- " * (8 + len(kinds)) + "|")
    for name, (arch, shape, mesh, over) in cells.CELLS.items():
        port, ref = runs["port"][name], runs["reference"][name]
        got = port["dot_flops_per_device"]
        reckoned = got + sum(cells._terms(name).values())
        terms = cells._wire_terms(name)
        wire = []
        for kind, ops in cells.KINDS.items():
            mine = cells._wire(port["collectives"], ops) - sum(terms.get(kind, {}).values())
            theirs = cells._wire(ref["collectives"], ops)
            wire.append(f"{mine:.4g} / {theirs:.4g}")
        total = (port["collectives"]["total_wire_bytes"], ref["collectives"]["total_wire_bytes"])
        cut = f", {over['n_layers']} layer{'s' * (over['n_layers'] > 1)}" if over else ""
        print(f"| {name} ({shape}{cut}) | {mesh} | {got:.5g} | {reckoned:.5g} "
              f"({reckoned / ref['flops'] - 1:+.3%}) | {ref['flops']:.5g} | "
              + " | ".join(wire) + f" | {total[0]:.4g} / {total[1]:.4g} "
              f"({total[0] / total[1]:.3f}) | " + " | ".join(
                  f"{port['memory'][k] / 2**30:.3f} / {ref['memory'][k] / 2**30:.3f}"
                  for k in ("argument_bytes", "peak_bytes_per_device")) + " |")


if __name__ == "__main__":
    main()
