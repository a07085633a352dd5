"""Analytic device models for the paper's §7 case study.

Memristive PIM (RACER-derived parameters, as in the paper): an 8 GB memory
built from 1024x1024 crossbars -> 64 Mi rows operating in lockstep; one
NOT/NOR column operation per cycle per array.  The GPU baseline is modeled at
its memory-bandwidth roofline -- the paper *measured* an RTX 3070 and found
throughput indistinguishable from that bound, which is what makes the model
transferable to this GPU-less container (DESIGN.md §7).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PIMDevice:
    name: str = "memristive-racer"
    rows: int = 1024
    cols: int = 1024
    total_bytes: int = 8 * 1024 ** 3
    cycle_ns: float = 10.0          # conservative RRAM switching + periphery
    gate_energy_fj: float = 24.3    # energy per column op per row (switching)
    init_counted: bool = True       # count output-init cycles

    @property
    def n_arrays(self) -> int:
        return self.total_bytes * 8 // (self.rows * self.cols)

    @property
    def parallel_rows(self) -> int:
        return self.n_arrays * self.rows          # 64 Mi for the defaults

    def cycles(self, cost) -> int:
        c = cost.nor_gates
        if self.init_counted:
            c += cost.init_cycles
        return c

    def latency_s(self, cost) -> float:
        return self.cycles(cost) * self.cycle_ns * 1e-9

    def throughput_ops(self, cost) -> float:
        """element ops / second at full memory occupancy (vector length ==
        parallel_rows; longer vectors batch with identical throughput)."""
        return self.parallel_rows / self.latency_s(cost)

    def energy_per_op_j(self, cost) -> float:
        return self.cycles(cost) * self.gate_energy_fj * 1e-15

    def throughput_per_watt(self, cost) -> float:
        return 1.0 / self.energy_per_op_j(cost)


@dataclasses.dataclass(frozen=True)
class GPUDevice:
    """Bandwidth-roofline GPU model (paper §7.2: measured == bound)."""
    name: str = "rtx3070"
    mem_bw: float = 448e9           # B/s
    tdp_w: float = 220.0

    def throughput_ops(self, elem_bytes: int, n_operands: int = 3) -> float:
        return self.mem_bw / (elem_bytes * n_operands)

    def throughput_per_watt(self, elem_bytes: int,
                            n_operands: int = 3) -> float:
        return self.throughput_ops(elem_bytes, n_operands) / self.tdp_w


@dataclasses.dataclass(frozen=True)
class TPUChip:
    """TPU v5e-class constants (per assignment) for the roofline analysis."""
    name: str = "tpu-v5e"
    peak_bf16_flops: float = 197e12
    hbm_bw: float = 819e9
    ici_bw: float = 50e9            # per link
    hbm_bytes: int = 16 * 1024 ** 3


PIM_DEFAULT = PIMDevice()
GPU_DEFAULT = GPUDevice()
TPU_DEFAULT = TPUChip()
