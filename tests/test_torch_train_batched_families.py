"""Training programs under ``Service.execute_batch`` on the CPU, the MoE,
Mamba and hybrid families: llama4-maverick (remat on, as the published
config has it), falcon-mamba-7b and jamba-1.5-large (reduced).  Each
round's N tasks as one ``torch.func.vmap`` call against the reference's
``execute_batch`` of its round (each task's loss within 1e-3) and against
the port's per-task rounds (losses 1e-5, deltas 1e-3 relative), with one
rule call a kernel launch of one task: the scan folds each task's own
``A``, remat runs every attention and scan forward twice.  The helpers
and the dense and MLA cases are in ``tests/test_torch_train_batched.py``.
"""

import pytest
import torch

from test_torch_train_batched import (against_per_task, against_reference, models,
                                      rule_calls_of)


@pytest.fixture(autouse=True)
def _torch_threads():
    """One intra-op thread for each test of this file, the previous count
    afterwards (as ``tests/test_torch_train.py`` sets it)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("arch,remat", [("llama4_maverick_400b_a17b", True),
                                        ("falcon_mamba_7b", False),
                                        ("jamba_1p5_large_398b", False)])
def test_batched_round_matches_the_reference_and_per_task(arch, remat):
    bat, per, calls = against_reference(arch, remat)
    cfg = models(arch, remat)[2].cfg
    assert cfg.remat is remat
    assert calls == rule_calls_of(cfg)
    against_per_task(bat, per)
    assert all(torch.isfinite(b["loss"]) for b in bat)
