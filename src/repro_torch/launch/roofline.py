"""Roofline analysis from dry-run records (EXPERIMENTS.md §Roofline).

Three terms per (arch x shape) cell on a mesh of ``CHIPS[mesh]``
accelerators, each at the chosen accelerator's rates (the port's card, the
H100 of ``core.device_model``, unless the caller passes another;
``TPU_DEFAULT`` gives the reference's analysis):

  compute    = HLO dot FLOPs / chip / peak_bf16_flops   (loop-aware census)
  memory     = analytic HBM traffic / chip / hbm_bw     (weights + optimizer
               + activations + KV; a compiler's 'bytes accessed' is not
               fusion-faithful, so traffic is modeled)
  collective = census wire bytes / chip / ici_bw        (loop-aware census)

plus MODEL_FLOPS = 6*N*D (train, N total for dense / N_active for MoE) or
2*N_active*D (forward-only), and the usefulness ratio MODEL_FLOPS /
(HLO_FLOPs x chips).

The records are the reference dry run's JSON (one file a cell: ``arch``,
``shape``, ``mesh``, ``skip``, ``variant``, ``hlo_dot_flops``,
``collectives``, ``memory``); ``CHIPS`` and ``TP`` name its meshes.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict

from ..configs import registry
from ..core.device_model import H100, TPUChip
from .steps import SHAPES, accum_for

CHIPS = {"16x16": 256, "2x16x16": 512}
TP = 16  # model-axis size on both meshes


def kv_cache_bytes(cfg, seq: int, batch: int) -> float:
    """Total decode-cache bytes for the whole model (bf16)."""
    per_tok = 0.0
    kinds = list(cfg.prefix) + list(cfg.group) * cfg.n_groups
    for kind in kinds:
        if kind in ("attn", "moe", "moe_dense"):
            if cfg.mla is not None:
                per_tok += (cfg.mla.kv_lora + cfg.mla.rope_head_dim) * 2
            else:
                per_tok += 2 * cfg.n_kv_heads * cfg.hd * 2
        elif kind == "local":
            per_tok += 0  # bounded window accounted below
    fixed = 0.0
    for kind in kinds:
        if kind == "local":
            fixed += 2 * cfg.window * cfg.n_kv_heads * cfg.hd * 2
        elif kind == "recurrent":
            fixed += (cfg.d_rnn or cfg.d_model) * 4 * 4
        elif kind == "rwkv":
            hd = cfg.d_model // cfg.n_heads
            fixed += cfg.n_heads * hd * hd * 4 + 2 * cfg.d_model * 2
    return batch * (seq * per_tok + fixed)


def traffic_model(cfg, plan, chips: int) -> Dict[str, float]:
    """Analytic per-device HBM bytes for one step."""
    pb = cfg.n_params * 2                      # bf16 weights
    pa = cfg.n_params_active * 2
    dp = chips // TP
    toks_local = plan.seq * plan.global_batch / max(dp, 1)
    d = cfg.d_model
    L = cfg.n_layers
    act_unit = toks_local * d * 2              # one activation tensor
    if plan.kind == "train":
        a = accum_for(cfg, plan)
        w = 4 * (pb / TP) * a                  # fwd + remat + 2 bwd passes
        opt = 24 * cfg.n_params / chips        # m,v,p fp32 r/w + grads
        acts = 12 * act_unit * L
        return {"weights": w, "optimizer": opt, "activations": acts,
                "kv": 0.0, "total": w + opt + acts}
    if plan.kind == "prefill":
        w = pa / TP
        acts = 8 * act_unit * L
        kv = kv_cache_bytes(cfg, plan.seq, plan.global_batch) / chips
        return {"weights": w, "optimizer": 0.0, "activations": acts,
                "kv": kv, "total": w + acts + kv}
    # decode: one token; whole active model + cache read per step
    w = pa / TP
    kv = kv_cache_bytes(cfg, plan.seq, plan.global_batch) / chips
    acts = 4 * plan.global_batch / max(dp, 1) * d * L * 2
    return {"weights": w, "optimizer": 0.0, "activations": acts,
            "kv": kv, "total": w + kv + acts}


def model_flops(cfg, plan) -> float:
    toks = plan.seq * plan.global_batch if plan.kind != "decode" \
        else plan.global_batch
    n = cfg.n_params_active if cfg.moe else cfg.n_params
    return (6 if plan.kind == "train" else 2) * n * toks


def analyze(rec: dict, *, accel: TPUChip = H100) -> dict:
    cfg = registry.get(rec["arch"])
    plan = SHAPES[rec["shape"]]
    chips = CHIPS[rec["mesh"]]
    t_c = rec["hlo_dot_flops"] / accel.peak_bf16_flops
    traffic = traffic_model(cfg, plan, chips)
    t_m = traffic["total"] / accel.hbm_bw
    coll_bytes = sum(v["bytes"] for v in rec["collectives"].values())
    t_n = coll_bytes / accel.ici_bw
    mf = model_flops(cfg, plan)
    hlo_total = rec["hlo_dot_flops"] * chips
    dominant = max(("compute", t_c), ("memory", t_m),
                   ("collective", t_n), key=lambda kv: kv[1])[0]
    bound = max(t_c, t_m, t_n)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "compute_s": t_c, "memory_s": t_m, "collective_s": t_n,
        "dominant": dominant,
        "model_flops": mf, "hlo_flops_total": hlo_total,
        "useful_ratio": mf / hlo_total if hlo_total else 0.0,
        "roofline_frac": (mf / accel.peak_bf16_flops / chips) / bound
        if bound else 0.0,
        "coll_bytes": coll_bytes,
        "traffic": traffic,
        "hbm_gb": rec.get("memory", {}).get("argument_size_in_bytes", 0)
        / 2 ** 30 + rec.get("memory", {}).get("temp_size_in_bytes", 0)
        / 2 ** 30,
    }


def load(out_dir="results/dryrun", mesh="16x16", *, accel: TPUChip = H100):
    rows = []
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("skip") or rec["mesh"] != mesh:
            continue
        if rec.get("variant", "baseline") != "baseline":
            continue            # perf-iteration records live in §Perf
        rows.append(analyze(rec, accel=accel))
    return rows


def markdown(out_dir="results/dryrun", *, accel: TPUChip = H100) -> str:
    lines = []
    lines.append("| arch | shape | compute s | memory s | collective s |"
                 " dominant | MODEL_FLOPS | useful ratio | roofline frac |")
    lines.append("|---|---|---|---|---|---|---|---|---|")
    for r in load(out_dir, accel=accel):
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3g} |"
            f" {r['memory_s']:.3g} | {r['collective_s']:.3g} |"
            f" **{r['dominant']}** | {r['model_flops']:.3g} |"
            f" {r['useful_ratio']:.2f} | {r['roofline_frac']:.3f} |")
    return "\n".join(lines)


if __name__ == "__main__":
    print(markdown())
