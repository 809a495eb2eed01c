"""Roofline analysis over the dry-run records: the reference package's
``repro/launch/roofline.py``, on one NVIDIA H100's constants.

Three terms per (arch x shape x mesh) cell, in seconds per step:

    compute    = FLOPs_per_device / peak_FLOP/s          (989 TF/s bf16, dense)
    memory     = bytes_per_device / HBM_bw               (3.35 TB/s)
    collective = wire_bytes_per_device / NVLink_bw       (450 GB/s each way)

FLOPs and wire bytes come from the dry run (``launch/dryrun.py``): the
local ops of one rank, so per device, and no further division by cards.
``MODEL_FLOPS`` is the analytic useful work (6·N_active·tokens for
training, 2·N_active·tokens for inference); MODEL_FLOPS / dry-run FLOPs
exposes remat, recompute and dispatch overheads.  The memory term is the
analytic streaming model (``analytic_memory_bytes``); the dry run's
operand-plus-result bytes, an upper bound, give ``memory_hlo_s``.

The constants are ``repro_torch.launch.mesh.HW``, one card's data-sheet
peaks: these are predictions, not timings.  One NVLink figure stands for
every link of a 256- or 512-card mesh, though NVLink joins only the 8
cards of a node and the mesh's other hops are slower: the collective
term is a lower bound, as the reference's single link constant is.

Usage:
    python -m repro_torch.launch.roofline --dir build/dryrun [--markdown out.md]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.mesh import HW
from repro_torch.models.registry import SHAPES

GiB = 2**30


def analytic_memory_bytes(rec: dict) -> float:
    """Per-device HBM traffic per step, streaming model (the fused view;
    the dry run's operand+result count is a pessimistic proxy because a
    fused kernel keeps most intermediates on chip):

      weights: fwd read (+remat re-read) + bwd read + grads r/w +
               optimizer state r/w                      [train]
               single read                              [prefill/decode]
      activations: ~20 x tokens x d x 2B per layer per pass (q,k,v,o,
               mlp h r/w, norms) + flash KV re-streaming (nq passes over
               the KV block stream)
      kv-cache: one full read per decode step
      unembed: table read x passes (chunked CE re-reads in bwd)
    """
    import repro_torch.configs as cfgs

    cfg = cfgs.get(rec["arch"])
    cell = SHAPES[rec["shape"]]
    N = rec["n_chips"]
    pb = 2  # bf16
    p_total, _ = cfg.param_counts()
    p_loc = p_total * pb / N
    opt_mult = {"float32": 8, "bfloat16": 4, "int8": 2.1}[cfg.opt_state_dtype]
    opt_loc = p_total * opt_mult / N

    if cell.kind == "decode":
        tokens = cell.global_batch
        if cfg.attention == "mla":
            per_tok = cfg.kv_lora_rank + cfg.qk_rope_head_dim
            att_layers = cfg.n_layers
        else:
            per_tok = 2 * cfg.n_kv_heads * cfg.head_dim
            att_layers = sum(1 for b in cfg.pattern if b.mixer == "attn"
                             ) * cfg.n_repeats
        window = cfg.long_context_window if rec["shape"].startswith("long") else None
        eff_len = min(cell.seq_len, window) if window else cell.seq_len
        kv_bytes = (att_layers * cell.global_batch * eff_len * per_tok * pb) / N
        ssm_bytes = 0
        if cfg.uses_mamba:
            m_layers = sum(1 for b in cfg.pattern if b.mixer == "mamba"
                           ) * cfg.n_repeats
            ssm_bytes = (m_layers * cell.global_batch * cfg.d_inner
                         * (cfg.ssm.state_dim + cfg.ssm.conv_width) * 4) / N
        act = 20 * tokens * cfg.d_model * pb * cfg.n_layers / N
        return p_loc + kv_bytes + 2 * ssm_bytes + act

    tokens_loc = cell.global_batch * cell.seq_len / N  # DP x SP sharded
    passes = 3.0 if cell.kind == "train" else 1.0  # fwd + remat + bwd
    act = 20 * tokens_loc * cfg.d_model * pb * cfg.n_layers * passes
    # flash attention streams the KV blocks once per q block
    if cfg.uses_attention:
        nq = max(cell.seq_len // 512, 1)
        att_layers = sum(1 for b in cfg.pattern if b.mixer == "attn"
                         ) * cfg.n_repeats
        kv_stream = (nq * 2 * tokens_loc * cfg.n_kv_heads * cfg.head_dim
                     * pb * att_layers * passes)
        act += kv_stream
    emb_read = 2 * cfg.vocab_size * cfg.d_model * pb / N * passes
    if cell.kind == "train":
        weights = 3 * p_loc + 2 * p_loc + 2 * (p_loc + opt_loc)
    else:
        weights = p_loc
    return weights + act + emb_read


def model_flops(rec: dict) -> float:
    """Useful work: 6·N_active·D (train) / 2·N_active·D (inference) plus the
    irreducible attention FLOPs (causal half-grid fwd; x3.5 for train to
    cover the flash backward's 5 matmuls)."""
    import repro_torch.configs as cfgs

    cfg = cfgs.get(rec["arch"])
    cell = SHAPES[rec["shape"]]
    n_active = rec["params_active"]
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    per_token = 6 * n_active if cell.kind == "train" else 2 * n_active
    total = per_token * tokens
    if cfg.uses_attention:
        att_layers = sum(1 for b in cfg.pattern if b.mixer == "attn"
                         ) * cfg.n_repeats
        B, S = cell.global_batch, cell.seq_len
        hd, H = cfg.head_dim, cfg.n_heads
        if cfg.attention == "mla":
            hd = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        if cell.kind == "decode":
            ctx = min(S, cfg.long_context_window or S) if rec[
                "shape"].startswith("long") else S
            attn = 4 * B * H * ctx * hd * att_layers
        else:
            # causal half grid: qk + pv = 2 matmuls over S^2/2 positions
            attn = 2 * B * H * S * S * hd * att_layers
            attn *= 3.5 if cell.kind == "train" else 1.0
        total += attn
    return total


def _advice(rec: dict, dom: str) -> str:
    kind = SHAPES[rec["shape"]].kind
    if dom == "collective":
        return ("run the attention and MoE inner loops under local_map so DTensor "
                "stops redistributing their operands (then overlap the remaining "
                "FSDP all-gathers with compute on a side stream)")
    if dom == "memory":
        if kind == "decode":
            return ("KV-cache layout: shard heads/seq wider or quantize "
                    "the cache to int8; MLA/windowed caches already help")
        return ("raise arithmetic intensity: fuse the optimizer, chunk larger, "
                "drop remat on memory-light layers")
    return ("cut non-useful FLOPs: causal block-skip in the flash kernels, "
            "selective remat, a cheaper attention backward")


def analyze_cell(rec: dict) -> dict | None:
    if rec.get("status") != "ok":
        return None
    flops_dev = rec["dot_flops_per_device"]
    op_bytes_dev = rec["bytes_accessed_per_device"]
    bytes_dev = analytic_memory_bytes(rec)
    wire_dev = rec["collectives"]["total_wire_bytes"]
    chips = rec["n_chips"]
    compute_s = flops_dev / HW["peak_flops_bf16"]
    memory_s = bytes_dev / HW["hbm_bandwidth"]
    coll_s = wire_dev / HW["nvlink_bandwidth"]
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    dom = max(terms, key=terms.get)
    mf = model_flops(rec)
    hlo_global = flops_dev * chips
    bound = max(terms.values())
    # roofline fraction: useful work at peak / modeled step time
    useful_s = mf / (chips * HW["peak_flops_bf16"])
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "kind": SHAPES[rec["shape"]].kind,
        "compute_s": compute_s, "memory_s": memory_s, "collective_s": coll_s,
        "memory_hlo_s": op_bytes_dev / HW["hbm_bandwidth"],
        "dominant": dom,
        "model_flops": mf,
        "hlo_flops_global": hlo_global,
        "useful_ratio": mf / hlo_global if hlo_global else 0.0,
        "roofline_fraction": useful_s / bound if bound else 0.0,
        "peak_gib": rec["memory"]["peak_bytes_per_device"] / GiB,
        "fits_hbm": rec["memory"]["peak_bytes_per_device"]
        <= HW["hbm_bytes"],
        "advice": _advice(rec, dom),
        "collective_counts": rec["collectives"]["count"],
    }


def load_dir(d: str) -> list[dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


def to_markdown(rows: list[dict], mesh: str = "single") -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | dominant "
           "| MODEL/HLO flops | roofline frac | peak GiB | fits |\n"
           "|---|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in rows:
        if r is None or r["mesh"] != mesh:
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3f} | "
            f"{r['memory_s']:.3f} | {r['collective_s']:.3f} | "
            f"**{r['dominant']}** | {r['useful_ratio']:.2f} | "
            f"{r['roofline_fraction']:.3f} | {r['peak_gib']:.1f} | "
            f"{'y' if r['fits_hbm'] else 'N'} |")
    return hdr + "\n".join(lines) + "\n"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=os.path.join("build", "dryrun"))
    ap.add_argument("--markdown", default=None)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    recs = load_dir(args.dir)
    rows = [analyze_cell(r) for r in recs]
    ok = [r for r in rows if r]
    skipped = [r for r in recs if r.get("status") == "skipped"]
    errors = [r for r in recs if r.get("status") == "error"]
    print(f"{len(ok)} analyzed, {len(skipped)} skipped (per assignment), "
          f"{len(errors)} errors")
    md = ("Predictions from one H100's data-sheet constants "
          f"({HW['peak_flops_bf16'] / 1e12:g} TFLOP/s bf16, "
          f"{HW['hbm_bandwidth'] / 1e12:g} TB/s HBM, "
          f"{HW['nvlink_bandwidth'] / 1e9:g} GB/s NVLink), not timings.\n\n")
    md += "## Single-pod (16x16 = 256 cards)\n\n" + to_markdown(ok, "single")
    md += "\n## Multi-pod (2x16x16 = 512 cards)\n\n" + to_markdown(ok, "multi")
    if skipped:
        md += "\n### Skipped cells\n" + "".join(
            f"- {r['arch']} x {r['shape']}: {r['reason']}\n" for r in skipped
            if r["mesh"] == "single")
    if errors:
        md += "\n### Cells that did not run\n" + "".join(
            f"- {r['arch']} x {r['shape']} ({r['mesh']}): {r.get('failed_op')}: "
            f"{r['error'][:200]}\n" for r in errors)
    if args.markdown:
        with open(args.markdown, "w") as f:
            f.write(md)
    else:
        print(md)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(ok, f, indent=1)


if __name__ == "__main__":
    main()
