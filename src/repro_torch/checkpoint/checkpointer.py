"""State checkpointing with atomic writes and an async writer.

The reference package's on-disk layout (``repro/checkpoint/checkpointer.py``):
``<dir>/step_<n>/arrays.npz`` + ``meta.json`` (the step and each array's
dtype; bf16 arrays are stored as their uint16 bit patterns).  Writes go
to a ``.tmp`` directory that is renamed into place, so a preempted save
never corrupts the latest checkpoint: the restart path (``latest_step``)
only ever sees complete directories.  ``AsyncCheckpointer`` copies the
state to host memory synchronously and writes it on a background thread.

A state is a tree of dicts whose leaves are tensors; an ``nn.Module``
node stands for its ``state_dict``.  Keys are the
port's own state paths: the keys from the root joined with "/", e.g.
``params/blocks.0.attn.wq`` or ``opt/m/embed.table``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
from torch import nn


def path_str(path) -> str:
    """A key path (a sequence of dict keys) as "/"-joined text."""
    return "/".join(str(k) for k in path)


def flatten(tree, prefix=()) -> dict:
    """{path: leaf} over the tree, in its order."""
    if isinstance(tree, nn.Module):
        items = tree.state_dict(keep_vars=True).items()
    elif isinstance(tree, dict):
        items = tree.items()
    else:
        return {path_str(prefix): tree}
    out = {}
    for k, sub in items:
        out.update(flatten(sub, prefix + (k,)))
    return out


def _to_host(flat: dict) -> tuple[dict, dict]:
    """(arrays, dtypes): numpy copies, bf16 as uint16 bit patterns."""
    arrays, dtypes = {}, {}
    for k, v in flat.items():
        if isinstance(v, torch.Tensor):
            t = v.detach().cpu()
            if t.dtype == torch.bfloat16:
                # a copy: on the CPU ``.cpu()`` is the live tensor, which the
                # optimizer writes in place while the snapshot persists
                arrays[k] = t.view(torch.int16).numpy().view(np.uint16).copy()
                dtypes[k] = "bfloat16"
                continue
            v = t.numpy()
        arrays[k] = np.array(v)
        dtypes[k] = str(arrays[k].dtype)
    return arrays, dtypes


def _write(ckpt_dir: str, step: int, arrays: dict, dtypes: dict,
           keep: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "dtypes": dtypes}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _gc(ckpt_dir, keep)
    return final


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3) -> str:
    return _write(ckpt_dir, step, *_to_host(flatten(tree)), keep)


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(_list_steps(ckpt_dir))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)


def _list_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return out


def latest_step(ckpt_dir: str) -> int | None:
    steps = _list_steps(ckpt_dir)
    return max(steps) if steps else None


@torch.no_grad()
def restore(ckpt_dir: str, step: int, like_tree):
    """Copy a checkpoint into the tensors of ``like_tree`` (same paths,
    shapes and dtypes), in place, on their devices; returns ``like_tree``."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        dtypes = json.load(f)["dtypes"]
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for k, leaf in flatten(like_tree).items():
            if k not in dtypes:
                raise KeyError(f"{path} has no array {k!r}")
            arr = data[k]
            if dtypes[k] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            if not isinstance(leaf, torch.Tensor) or leaf.shape != t.shape \
                    or leaf.dtype != t.dtype:
                raise ValueError(f"{k}: checkpoint holds {t.dtype} "
                                 f"{tuple(t.shape)}, the state "
                                 f"{getattr(leaf, 'dtype', type(leaf))} "
                                 f"{tuple(getattr(leaf, 'shape', ()))}")
            leaf.copy_(t)
    return like_tree


class Checkpointer:
    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep

    def save(self, step: int, tree) -> str:
        return save(self.ckpt_dir, step, tree, keep=self.keep)

    def restore_latest(self, like_tree):
        step = latest_step(self.ckpt_dir)
        if step is None:
            return None, None
        return step, restore(self.ckpt_dir, step, like_tree)


class AsyncCheckpointer(Checkpointer):
    """Snapshot to host synchronously, persist asynchronously."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        super().__init__(ckpt_dir, keep)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save(self, step: int, tree) -> str:
        self.wait()
        arrays, dtypes = _to_host(flatten(tree))

        def _persist():
            try:
                _write(self.ckpt_dir, step, arrays, dtypes, self.keep)
            except Exception as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=_persist, daemon=True)
        self._thread.start()
        return os.path.join(self.ckpt_dir, f"step_{step:08d}")

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
