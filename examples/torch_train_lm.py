"""End-to-end training run on the PyTorch/CUDA port: a small
llama-family model for a few hundred steps on the learnable Markov
stream; the loss must drop by more than a nat.  Also demonstrates
checkpoint/restart mid-run.

The port's counterpart of ``examples/train_lm.py``, with the same model
(``llama3p2_1b`` scaled to 8 layers of d_model 512, fp32;
``cfg.param_counts()`` prints its size), schedule and data.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu \
        --steps 60 --layers 2 --d-model 128 --batch 4 --seq-len 32

Runs on ``cuda:0`` by default; ``--device cpu`` runs it on the CPU.
``--layers`` and ``--d-model`` shrink the model (default 8 and 512; the
heads keep a head dim of 64) so a CPU run stays short.
"""

import argparse
import math
import tempfile

import repro_torch.configs as cfgs
from repro_torch.checkpoint import AsyncCheckpointer
from repro_torch.data import make_dataset
from repro_torch.device import resolve_device
from repro_torch.models import build
from repro_torch.runtime.train_loop import TrainConfig, Trainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)

    # a scaled llama3-family config
    heads = args.d_model // 64
    cfg = cfgs.get("llama3p2_1b").replace(
        n_layers=args.layers, d_model=args.d_model, n_heads=heads,
        n_kv_heads=max(heads // 2, 1), head_dim=64, d_ff=4 * args.d_model,
        vocab_size=args.vocab, param_dtype="float32", compute_dtype="float32",
        remat=False)
    total, _ = cfg.param_counts()
    print(f"model: {total/1e6:.1f}M params, ln(V) = {math.log(args.vocab):.3f}, "
          f"on {device}")

    api = build(cfg)
    tc = TrainConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps,
                     schedule="cosine")
    ds = make_dataset("markov", cfg.vocab_size, args.seq_len, args.batch,
                      seed=0, noise=0.02)

    with tempfile.TemporaryDirectory() as d:
        ck = AsyncCheckpointer(d)
        tr = Trainer(api, tc, ds, checkpointer=ck, ckpt_every=100, device=device)
        half = args.steps // 2
        tr.run(half)
        print(f"[step {half}] loss {tr.metrics_log[-1]['loss']:.4f} "
              "— simulating preemption + restart from checkpoint")
        tr2 = Trainer(api, tc, ds, checkpointer=ck, ckpt_every=100, device=device)
        print(f"restarted at step {tr2.start_step}")
        assert tr2.start_step == half
        tr2.run(args.steps - tr2.start_step)
        ck.wait()
        first = tr.metrics_log[0]["loss"]
        last = tr2.metrics_log[-1]["loss"]
        print(f"loss: {first:.4f} -> {last:.4f} "
              f"(target << {math.log(args.vocab):.3f}); drop {first - last:.4f}")
        assert last < first - 1.0, "loss should drop by >1 nat"
        print("OK")


if __name__ == "__main__":
    main()
