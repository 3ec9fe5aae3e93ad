"""Hardware record the planner prices against: one NVIDIA H100 SXM.

Datasheet figures (NVIDIA H100 SXM data sheet and the Hopper architecture
white paper; dense rates, 700 W part), named as such — no figure here was
measured by this repository:

  peak bf16 tensor-core rate : 989e12 FLOP/s
  HBM3 bandwidth             : 3.35e12 B/s
  HBM capacity               : 80e9 B
  NVLink                     : 900e9 B/s all-to-all per card, 450e9 each way
  shared memory per block    : 232,448 B (227 KiB of the SM's 256 KiB;
                               takes the place of the TPU's VMEM size)

``link_latency`` (the α of the planner's α + β·b model) is no datasheet
figure: it keeps the JAX package's 1 µs per collective until a fitted
profile of the card's collectives exists (``RunConfig.hw_profile``).

The JAX package's TPU v5e record (``repro/utils/roofline.py``) prices a
different machine; none of its numbers carry over.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Hardware:
    name: str = "h100-sxm"
    peak_flops: float = 989e12      # bf16 FLOP/s, dense (datasheet)
    hbm_bw: float = 3.35e12         # bytes/s (datasheet)
    link_bw: float = 450e9          # bytes/s per card, NVLink each way (β₁)
    hbm_bytes: float = 80e9         # device memory (datasheet)
    smem_bytes: float = 232448      # shared memory one block can use
    link_latency: float = 1e-6      # s per collective message (α₁, assumed)
    # inter-host tier: None = single-tier fabric (see core/cost_model.py)
    inter_bw: float | None = None
    inter_latency: float | None = None

    @property
    def hierarchical(self) -> bool:
        return self.inter_bw is not None and self.inter_latency is not None


HW = Hardware()
