"""The kernels under ``torch.func.vmap``: one folding rule for every
kernel entry, forward and backward.

``Service.execute_batch`` computes N tasks as one call of
``torch.func.vmap(program.fn)``.  Inside it a kernel's wrapper would meet
BatchedTensors, from which neither ``data_ptr()`` nor a TMA descriptor
can be taken.  So each kernel entry that a served or trained model
reaches has a vmap rule: ``flash_attention_fwd``, ``flash_attention_bwd``
(the dq and dk/dv pair) and ``decode_attention_fwd`` are
``torch.library.custom_op``s with ``register_vmap`` (and
``register_fake``); the differentiable scan (``mamba_scan``, an
``autograd.Function``, ``DISPATCH.scan``) carries the rule as its own
``vmap`` staticmethod, its one route under vmap.  The rule folds the
vmapped task axis into the kernel's batch axis:

- each batched input has its vmapped dim moved to the front; an input
  that is not batched but must be (``in_dims`` None on q, k, v, out, lse,
  the cotangent, the caches, x, dt, B, C, h0) is expanded to the N tasks;
- the input is made contiguous and (N, B, ...) reshaped to (N·B, ...);
- the wrapper launches ONE kernel (the backward: one dq and one dk/dv
  launch) on the folded tensors, on the card, or runs the plain version
  on CPU tensors, so the fold is the same on both;
- every output is unfolded, (N·B, ...) -> (N, B, ...), at dim 0.

A training program runs under ``vmap(grad(...))``: the differentiable
flash attention (``ops._Flash``, ``generate_vmap_rule``) runs its forward
and its backward at the vmap level, each through its entry's rule, so N
tasks' forward, dq and dk/dv launch as often as one task's.  The scan's
``A`` is one (d, n) matrix for the whole batch when it arrives unbatched
(the serving path, weights closed over) and one a batch row when it
arrives batched (a training task's own weights): the rule expands it to
(N·B, d, n), which the kernel reads through its batch stride.  An input a
kernel cannot fold (decode's ``cache_index``) raises ``ValueError``
naming it when it arrives batched: there is no per-task loop and no quiet
fall back to the plain version.

The per-task path does not enter the ops: a wrapper calls its op only
when one of its tensors is a BatchedTensor (``under_vmap``; the backward
whenever one is any functorch wrapper, ``under_transform``, whose
``data_ptr()`` it could not take), and otherwise runs as it always did, so its launches and host cost stay as
they were.  Through the ops, every call cost ~20 µs more host time than
the wrapper alone, and qwen3-1.7B's per-task decode step 5-6% more
(``tools/per_task_cost.py`` on an NVIDIA H100 80GB HBM3 at 700 W).  ``RULE_CALLS`` counts each rule's calls, one per folded
launch (the backward's: one per dq and dk/dv pair), beside each kernel's
launch counter: a caller can tell that the rule ran, and not a native
vmap of the plain ops.
"""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor

RULE_CALLS = {"flash_attention_fwd": 0, "flash_attention_bwd": 0,
              "decode_attention_fwd": 0, "mamba_scan": 0}


def reset_rule_calls() -> None:
    for name in RULE_CALLS:
        RULE_CALLS[name] = 0


def under_vmap(*tensors) -> bool:
    """Whether any of ``tensors`` is a BatchedTensor of ``torch.func.vmap``,
    itself or under the grad transform's wrappers (a backward under
    ``vmap(grad(...))`` meets its saved tensors so; None entries are
    skipped).  Outside every functorch transform, on the per-task path, one
    look at the transform stack answers, at a sixth of the host time of
    testing each tensor."""
    if torch._C._functorch.peek_interpreter_stack() is None:
        return False
    return any(t is not None and _batched_within(t) for t in tensors)


def under_transform(*tensors) -> bool:
    """Whether any of ``tensors`` is a functorch wrapper: a BatchedTensor
    of ``vmap`` or a ``torch.func.grad``/``vjp`` level's tensor, whose
    ``data_ptr()`` no kernel can take.  A kernel entry given one goes
    through its custom op, which unwraps it (and folds it, if batched)."""
    if torch._C._functorch.peek_interpreter_stack() is None:
        return False
    wrapped = torch._C._functorch.is_functorch_wrapped_tensor
    return any(t is not None and wrapped(t) for t in tensors)


def is_fake(*tensors) -> bool:
    """Whether any of ``tensors`` is a ``FakeTensor`` (the dry run,
    ``launch/dryrun.py``; None entries are skipped): a CUDA wrapper given
    one enters its kernel's op, whose fake impl runs, and builds and
    launches nothing (no pointer of a fake tensor is real)."""
    return any(isinstance(t, FakeTensor) for t in tensors)


def unwrapped(t):
    """``t`` without the wrappers of a function transform that has already
    returned: ``torch.func.vjp``'s function runs the backward after its
    transform's level is gone (remat's recompute under ``.backward()``),
    and the saved tensors it meets are that level's wrappers, from which
    no ``data_ptr()`` can be taken."""
    F = torch._C._functorch
    while F.is_functorch_wrapped_tensor(t):
        t = F.get_unwrapped(t)
    return t


def _batched_within(t) -> bool:
    F = torch._C._functorch
    while F.is_gradtrackingtensor(t):
        t = F.get_unwrapped(t)
    return F.is_batchedtensor(t)


def fold(entry: str, n: int, names, tensors, in_dims, *, fixed=()):
    """The inputs of one folded launch of ``entry`` for ``n`` tasks.

    ``tensors`` are the rule's unwrapped inputs (None stays None), each
    batched along its entry of ``in_dims`` or not batched (None).  Those
    named in ``fixed`` go through unchanged and raise when batched; every
    other one becomes contiguous (n·B, ...).  Counts the rule's call."""
    out = []
    for name, t, d in zip(names, tensors, in_dims):
        if name in fixed:
            if d is not None:
                raise ValueError(
                    f"{entry} under vmap: input {name} arrived batched (shape "
                    f"{tuple(t.shape)}, vmapped dim {d}); the kernel takes one "
                    f"{name} for the whole batch and cannot fold it")
            out.append(t)
            continue
        if t is None:
            out.append(None)
            continue
        t = t.movedim(d, 0) if d is not None else t.unsqueeze(0).expand(n, *t.shape)
        out.append(t.contiguous().reshape(n * t.shape[1], *t.shape[2:]))
    RULE_CALLS[entry] += 1
    return out


def unfold(t: torch.Tensor, n: int) -> torch.Tensor:
    """A folded output (n·B, ...) as (n, B, ...), vmapped at dim 0."""
    return t.reshape(n, t.shape[0] // n, *t.shape[1:])
