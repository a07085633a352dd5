"""Analytic PIM-offload planner: where would AritPIM beat the accelerator?

For an (arch x shape) serving cell, enumerates the elementwise/vector ops a
decode step performs and compares, per op:

  * accelerator time = bytes_moved / mem_bw    (these ops are bandwidth-
                       bound on any von-Neumann device -- the paper's §7
                       observation)
  * PIM time         = cycles(op) * cycle_time (independent of vector
                       length up to 64 Mi rows -- element-parallel
                       execution)

The planner answers the deployment question the paper poses: data-intensive,
memory-bound arithmetic belongs *in* the memory.  GEMM-shaped work stays on
the accelerator's matrix units (PIM multiply throughput is per-element, not
per-MAC-array).

The accelerator is the port's card, the H100 (``core.device_model.H100``),
unless the caller passes another: with ``TPU_DEFAULT`` the plan and the
report are the reference's.

    PYTHONPATH=src python -m repro_torch.core.offload
"""

from __future__ import annotations

import dataclasses
from typing import List

from . import bitserial, bitserial_fp
from .device_model import H100, PIM_DEFAULT, TPU_DEFAULT, TPUChip
from .floatfmt import BF16
from ..models.config import ModelConfig


@dataclasses.dataclass
class OpPlan:
    """One op class of a decode step.  ``tpu_us`` keeps the reference's
    name: it holds the chosen accelerator's bandwidth-bound time."""
    name: str
    n_elems: int
    tpu_us: float
    pim_us: float
    offload: bool
    note: str = ""


def _pim_cost(kind: str):
    if kind == "add":
        return bitserial_fp.build_fp_add(BF16).cost()
    if kind == "mul":
        return bitserial_fp.build_fp_mul(BF16).cost()
    return bitserial.build_add(32).cost()


def decode_step_plan(cfg: ModelConfig, batch: int, seq: int, *,
                     accel: TPUChip = H100) -> List[OpPlan]:
    """Elementwise work in one decode step (per layer aggregated)."""
    d = cfg.d_model
    L = cfg.n_layers
    plans = []
    pim = PIM_DEFAULT

    def add(name, kind, n, note=""):
        # bandwidth-bound elementwise op on the accelerator: 3 operands x
        # 2 bytes
        acc_us = n * 6 / accel.hbm_bw * 1e6
        c = _pim_cost(kind)
        pim_us = pim.latency_s(c) * 1e6 if n <= pim.parallel_rows else \
            pim.latency_s(c) * 1e6 * (n / pim.parallel_rows)
        plans.append(OpPlan(name, n, round(acc_us, 3), round(pim_us, 3),
                            offload=pim_us < acc_us, note=note))

    add("residual adds", "add", 2 * L * batch * d)
    add("rmsnorm scale/shift", "mul", 2 * L * batch * d)
    add("swiglu gate mul", "mul", L * batch * cfg.d_ff)
    if "rwkv" in cfg.group:
        add("wkv decay/gate elementwise", "mul",
            L * batch * d * 4, "decay, bonus, gates")
    if "recurrent" in cfg.group:
        add("rg-lru gating", "mul", L * batch * (cfg.d_rnn or d) * 3)
    add("kv-cache append", "add", L * batch * 2 * cfg.n_kv_heads * cfg.hd,
        "write-only; PIM native")
    return plans


def report(cfg: ModelConfig, batch: int = 128, seq: int = 32768, *,
           accel: TPUChip = H100) -> str:
    """The plan as text: under ``TPU_DEFAULT`` the reference's, byte for
    byte; under another accelerator its name in the header and the time
    column (``h100_us``)."""
    rows = decode_step_plan(cfg, batch, seq, accel=accel)
    col = accel.name.split("-")[0] + "_us"
    head = f"PIM offload plan: {cfg.name}, decode batch={batch} seq={seq}"
    if accel != TPU_DEFAULT:
        head += f" on {accel.name}"
    out = [head,
           f"{'op':28s} {'elems':>12s} {col:>9s} {'pim_us':>9s} off?"]
    for r in rows:
        out.append(f"{r.name:28s} {r.n_elems:12d} {r.tpu_us:9.3f} "
                   f"{r.pim_us:9.3f} {'YES' if r.offload else 'no '}"
                   f"  {r.note}")
    n_off = sum(r.offload for r in rows)
    out.append(f"-> {n_off}/{len(rows)} op classes clear the PIM bar "
               f"(small vectors lose: latency is cycle-bound; the win is "
               f"throughput at >= Mi-scale element counts)")
    return "\n".join(out)


if __name__ == "__main__":
    from ..configs import registry
    print(report(registry.get("rwkv6-1.6b")))
