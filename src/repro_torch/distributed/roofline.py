"""Three-term roofline model for one NVIDIA H100 SXM; counterpart of
``repro.distributed.roofline``, with the H100's constants in place of the
TPU's.

  compute term    = step FLOPs       / (chips * peak FLOP/s)
  memory term     = step bytes       / (chips * HBM bandwidth)
  collective term = collective bytes / (chips * link bandwidth)

The FLOPs and bytes come from ``hlo_costs.count_costs`` over the step on
the meta device (the dry run); whole-module totals, hence the division.
The dry run lowers the steps of one device, which move no collective
bytes, so it leaves ``collective_bytes`` at 0 until the production meshes
fill it (ROADMAP.md, Queue A 10b.2).
``kernel_bound_s`` gives one hand-written kernel call's least time on the
card, the bound of the kernel table in ``PERF.md``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.kernels._costs import KernelCost

# dense bf16 on the tensor cores, H100 SXM5 (NVIDIA's H100 datasheet: 1979
# TFLOP/s with 2:4 sparsity, half of it dense)
PEAK_FLOPS_BF16 = 989.4e12
# f32 outside the tensor cores, H100 SXM5 (datasheet: 67 TFLOP/s); the
# elementwise kernels compute in f32 whatever their storage type
PEAK_FLOPS_F32 = 67e12
# HBM3, H100 SXM5 (datasheet: 3.35 TB/s)
HBM_BW = 3.35e12
# NVLink 4 in one direction (datasheet: 900 GB/s both ways per GPU): stands
# in for the TPU's ICI
ICI_BW = 450e9
# one 400 Gb/s NDR InfiniBand port per GPU: stands in for the TPU's DCN
DCN_BW = 50e9
# device memory of one H100 SXM5 (datasheet: 80 GB); on the card the dry
# run reads ``torch.cuda.get_device_properties`` instead
HBM_BYTES = 80e9
# the rate of a kernel's operations by their type (``KernelCost.ops_type``)
PEAK_OPS = {"bfloat16": PEAK_FLOPS_BF16, "float32": PEAK_FLOPS_F32}


@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    model_flops: float  # 6·N·D (dense) / 6·N_active·D (MoE); 2·N·D serve
    collective_bytes: float = 0.0
    pod_collective_bytes: float = 0.0  # portion crossing the DCN "pod" axis
    notes: str = ""

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS_BF16)

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def collective_s(self) -> float:
        ici = (self.collective_bytes - self.pod_collective_bytes) / (self.chips * ICI_BW)
        dcn = self.pod_collective_bytes / (max(self.chips // 256, 1) * DCN_BW)
        return ici + dcn

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / step FLOPs — catches remat & redundancy waste."""
        if self.hlo_flops <= 0:
            return 0.0
        return self.model_flops / self.hlo_flops

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU at the roofline: useful FLOPs / (chips * peak *
        step_time); for memory/collective-bound cells it is what the
        bottleneck allows."""
        t = self.step_time_s
        if t <= 0:
            return 0.0
        return self.model_flops / (self.chips * PEAK_FLOPS_BF16 * t)

    def row(self) -> Dict[str, str]:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "compute_s": f"{self.compute_s:.4f}",
            "memory_s": f"{self.memory_s:.4f}",
            "collective_s": f"{self.collective_s:.4f}",
            "dominant": self.dominant,
            "model/hlo_flops": f"{self.useful_flops_fraction:.3f}",
            "roofline_frac": f"{self.roofline_fraction:.3f}",
        }

    def render(self) -> str:
        r = self.row()
        return (
            f"{r['arch']:24s} {r['shape']:12s} {r['mesh']:10s} "
            f"C={r['compute_s']}s M={r['memory_s']}s X={r['collective_s']}s "
            f"dom={r['dominant']:10s} useful={r['model/hlo_flops']} "
            f"RF={r['roofline_frac']}"
        )


def kernel_bound_s(cost: KernelCost) -> float:
    """The least time of one kernel call on the card: the larger of its
    bytes over the HBM rate and its operations over the peak of their type."""
    return max(cost.bytes / HBM_BW, cost.ops / PEAK_OPS[cost.ops_type])
