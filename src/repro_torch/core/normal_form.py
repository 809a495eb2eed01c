"""Normal-form rewriting (Aldinucci & Danelutto 1999, as used by JJPF).

Any composition of ``Farm`` and ``Pipe`` over sequential programs is
semantically a single farm whose worker is the *sequential composition* of
all the stage programs, in pipeline order:

    NF(seq(f))            = farm(seq(f))
    NF(farm(W))           = NF(W)                 (farm is idempotent on streams)
    NF(pipe(S1, ..., Sn)) = farm(seq(fn ∘ ... ∘ f1))   with fi from NF(Si)

The paper: *"applications made of a composition of task farm and pipeline
patterns are automatically pre-processed to get their normal form and are
then submitted to the distributed slaves."*  The fused worker is ONE program
per task on the service's device: no inter-stage host transfers.
"""

from __future__ import annotations

from .skeletons import Farm, Pipe, Program, Seq, Skeleton, compose_programs


def collect_stage_programs(skel: Skeleton) -> list[Program]:
    """Flatten a skeleton into its ordered list of sequential programs."""
    if isinstance(skel, Seq):
        return [skel.program]
    if isinstance(skel, Farm):
        return collect_stage_programs(skel.worker)
    if isinstance(skel, Pipe):
        out: list[Program] = []
        for s in skel.stages:
            out.extend(collect_stage_programs(s))
        return out
    raise TypeError(f"unknown skeleton node: {skel!r}")


def normalize(skel: Skeleton) -> Farm:
    """Rewrite to normal form: ``farm(seq(f_n ∘ ... ∘ f_1))``."""
    programs = collect_stage_programs(skel)
    if len(programs) == 1:
        return Farm(Seq(programs[0]))
    return Farm(Seq(compose_programs(programs)))


def normal_form_depth(skel: Skeleton) -> int:
    """Number of sequential stages fused by normalization (for reporting)."""
    return len(collect_stage_programs(skel))


def coerce_program(program) -> tuple[Program, int]:
    """The farm drivers' shared entry point (paper §2 pre-processing):
    a skeleton composition collapses to its fused normal-form worker, a
    bare callable wraps into a ``Program``.  Returns (program, number of
    fused stages)."""
    if isinstance(program, Skeleton):
        return normalize(program).worker.program, normal_form_depth(program)
    if not isinstance(program, Program):
        return Program(program), 1
    return program, 1
