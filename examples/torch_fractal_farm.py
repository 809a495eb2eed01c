"""Mandelbrot tiles over the farm on the PyTorch/CUDA port — the paper's
canonical example family ("several fractal calculations, basically all the
ones where each point can be calculated independently").

The port's counterpart of ``examples/fractal_farm.py``, with its image,
tiles, iteration count and services.  Each task is one image tile; the
worker program is the escape-time loop in plain PyTorch on complex64
tensors on the service's device (the reference runs it as a ``lax.scan``
outside any Pallas kernel, so no kernel is written for it).  A slow
service (``task_delay_s``) and one that dies after 2 tiles (``fail_after``)
show load balancing and fault tolerance on a heterogeneous 'cluster'.

    PYTHONPATH=src python examples/torch_fractal_farm.py
    PYTHONPATH=src python examples/torch_fractal_farm.py --device cpu

Runs on ``cuda:0`` by default; ``--device cpu`` runs it on the CPU.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core import BasicClient, LookupService, Program, Service
from repro_torch.device import resolve_device

SIZE = 256  # full image (SIZE x SIZE)
TILE = 64
MAX_ITER = 64


def mandelbrot_tile(task):
    """task: {"x0","y0"} tile origin in [0,1]^2 of the complex window."""
    x0, y0 = task["x0"], task["y0"]
    steps = torch.arange(TILE, device=x0.device)
    xs = x0 + steps / SIZE
    ys = y0 + steps / SIZE
    re = -2.0 + 2.7 * xs[None, :]
    im = -1.2 + 2.4 * ys[:, None]
    c = torch.complex(re.expand(TILE, TILE), im.expand(TILE, TILE))
    z = torch.zeros_like(c)
    n = torch.zeros(c.shape, dtype=torch.int32, device=c.device)
    for i in range(1, MAX_ITER + 1):
        z = z * z + c
        n = torch.where((z.abs() > 2.0) & (n == 0), i, n)
    return {"x0": x0, "y0": y0, "tile": n}


def tasks():
    """One task a tile, row by row, as the reference lists them."""
    return [{"x0": torch.tensor(x / SIZE), "y0": torch.tensor(y / SIZE)}
            for y in range(0, SIZE, TILE) for x in range(0, SIZE, TILE)]


def assemble(out) -> np.ndarray:
    """The (SIZE, SIZE) image of escape iterations from the tiles."""
    img = np.zeros((SIZE, SIZE), np.int32)
    for r in out:
        x0 = int(round(float(r["x0"]) * SIZE))
        y0 = int(round(float(r["y0"]) * SIZE))
        img[y0:y0 + TILE, x0:x0 + TILE] = r["tile"].cpu().numpy()
    return img


def preview(img) -> list[str]:
    """The reference's crude ASCII preview."""
    chars = " .:-=+*#%@"
    return ["".join(chars[min(int(v) * len(chars) // MAX_ITER, len(chars) - 1)] for v in row)
            for row in img[:: SIZE // 24, :: SIZE // 48]]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)

    lookup = LookupService()
    services = [
        Service(lookup, device=device, service_id="fast-0"),
        Service(lookup, device=device, service_id="fast-1"),
        Service(lookup, device=device, service_id="slow", task_delay_s=0.02),
        Service(lookup, device=device, service_id="flaky"),
    ]
    for s in services:
        s.start()
    services[-1].fail_after(2)  # dies after 2 tiles; tasks get rescheduled

    work = tasks()
    out: list = []
    t0 = time.perf_counter()
    cm = BasicClient(Program(mandelbrot_tile, name="mandelbrot"), None,
                     work, out, lookup=lookup, lease_s=10.0)
    cm.compute(timeout=600)
    dt = time.perf_counter() - t0

    img = assemble(out)
    stats = cm.stats()
    print(f"{len(work)} tiles in {dt:.2f}s on {device}; interior fraction "
          f"{(img == 0).mean():.3f}")
    print("per-service:", stats["per_service"])
    print("reschedules:", stats["reschedules"])
    print("\n".join(preview(img)))
    assert len(out) == len(work) and sorted(
        (float(r["x0"]), float(r["y0"])) for r in out) == sorted(
        (float(t["x0"]), float(t["y0"])) for t in work)
    assert 0 < (img == 0).mean() < 1 and img.max() <= MAX_ITER
    print("OK")


if __name__ == "__main__":
    main()
