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
  streaming multiprocessors  : 132

``link_latency`` (the α of the planner's α + β·b model) is no datasheet
figure: it keeps the JAX package's 1 µs per collective until a fitted
profile of the card's collectives exists (``RunConfig.hw_profile``).

The JAX package's TPU v5e record (``repro/utils/roofline.py``) prices a
different machine; none of its numbers carry over.

Conventions of the roofline terms (``RooflineTerms``, the dry-run's):
per-card FLOPs (the dry step's counted operations), per-card HBM bytes
(utils/traffic.py's model) and per-card collective wire bytes (the
record's, ring factors applied) over this record's peak rate, HBM rate
and link rate; the step is bound by the largest of the three.

The embedding kernels' tile (``kernel_tile_candidates``,
``embed_tile_seconds``) is the one-pass scatter's rows per block R
(csrc/embed_scatter_fused.cu, kernels/ops.py::scatter_partition), not the
reference's 128-lane feature tile: the kernel writes whole rows, and R
decides how many blocks cut [0, Vs) and how often each reads the ids.
"""
from __future__ import annotations

import math
from dataclasses import asdict, dataclass


@dataclass(frozen=True)
class Hardware:
    name: str = "h100-sxm"
    peak_flops: float = 989e12      # bf16 FLOP/s, dense (datasheet)
    hbm_bw: float = 3.35e12         # bytes/s (datasheet)
    link_bw: float = 450e9          # bytes/s per card, NVLink each way (β₁)
    hbm_bytes: float = 80e9         # device memory (datasheet)
    smem_bytes: float = 232448      # shared memory one block can use
    link_latency: float = 1e-6      # s per collective message (α₁, assumed)
    sm_count: int = 132             # streaming multiprocessors (datasheet)
    # inter-host tier: None = single-tier fabric (see core/cost_model.py)
    inter_bw: float | None = None
    inter_latency: float | None = None

    @property
    def hierarchical(self) -> bool:
        return self.inter_bw is not None and self.inter_latency is not None


HW = Hardware()

# the one-pass scatter's block map holds 4 B a row in shared memory, at
# most this many rows (kernels/ops.py::_SCATTER_MAX_ROWS)
SCATTER_MAX_ROWS = 8192


def kernel_tile_candidates(vs: int, hw: Hardware = HW) -> list:
    """Rows-per-block (R) candidates for the one-pass scatter of a table
    of ``vs`` rows. 0 — ``scatter_partition``'s own choice — is always
    first, so a measured argmin over this list never loses to the untuned
    default; the others are powers of two from 16 to 8,192 rows whose
    block map (4 B a row) fits ``hw.smem_bytes`` and that cut [0, Vs)
    into at least two blocks."""
    cands = [0]
    r = 16
    while r <= SCATTER_MAX_ROWS:
        if 4 * r <= hw.smem_bytes and r < vs:
            cands.append(r)
        r *= 2
    return cands


def embed_tile_seconds(n: int, e: int, rows: int, itemsize: int, vs: int,
                       hw: Hardware = HW, step_overhead: float = 2e-7
                       ) -> float:
    """Roofline estimate of one one-pass scatter of ``n`` rows of ``e``
    elements (``itemsize`` bytes each) into (``vs``, e) f32 at R =
    ``rows`` (0: ``scatter_partition``'s): the output written and the rows
    read once, every block reading all n ids, at the HBM rate scaled by
    the share of the SMs the G blocks occupy, plus a fixed overhead a wave
    of blocks. The autotuner ranks candidates with it before measuring;
    the measured argmin decides."""
    if not rows:
        from repro_torch.kernels.ops import scatter_partition
        rows = scatter_partition(vs, e, n)[0]
    g = max(-(-vs // rows), 1)
    nbytes = vs * e * 4 + n * e * itemsize + g * 4 * n
    fill = min(1.0, g / hw.sm_count)
    return (nbytes / (hw.hbm_bw * fill)
            + math.ceil(g / hw.sm_count) * step_overhead)


@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    per_chip_flops: float
    per_chip_hbm_bytes: float
    per_chip_collective_bytes: float
    model_flops_global: float       # 6*N*D (dense) or 6*N_active*D (MoE)
    per_chip_peak_memory: float     # the dry step's peak live bytes
    collective_breakdown: dict | None = None

    @property
    def compute_s(self) -> float:
        return self.per_chip_flops / HW.peak_flops

    @property
    def memory_s(self) -> float:
        return self.per_chip_hbm_bytes / HW.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.per_chip_collective_bytes / HW.link_bw

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs (global): remat and redundancy
        show as a fraction below 1."""
        counted = self.per_chip_flops * self.chips
        if counted <= 0:
            return 0.0
        return self.model_flops_global / counted

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time / critical-path bound:
        (MODEL_FLOPS / (chips * peak)) / max(compute_s, memory_s, coll_s)."""
        ideal = self.model_flops_global / (self.chips * HW.peak_flops)
        b = self.bound_s
        return ideal / b if b > 0 else 0.0

    def to_dict(self) -> dict:
        d = asdict(self)
        d.update(
            compute_s=self.compute_s,
            memory_s=self.memory_s,
            collective_s=self.collective_s,
            dominant=self.dominant,
            bound_s=self.bound_s,
            useful_flops_fraction=self.useful_flops_fraction,
            roofline_fraction=self.roofline_fraction,
        )
        return d


def roofline_from_analysis(*, arch: str, shape: str, mesh: str, chips: int,
                           cost: dict, collective_bytes: float,
                           model_flops_global: float, peak_memory: float,
                           collective_breakdown: dict | None = None
                           ) -> RooflineTerms:
    """``cost``: {"flops": per-card FLOPs, "bytes accessed": per-card HBM
    bytes}; ``collective_bytes``: per-card wire bytes."""
    return RooflineTerms(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        per_chip_flops=float(cost.get("flops", 0.0)),
        per_chip_hbm_bytes=float(cost.get("bytes accessed", 0.0)),
        per_chip_collective_bytes=float(collective_bytes),
        model_flops_global=model_flops_global,
        per_chip_peak_memory=float(peak_memory),
        collective_breakdown=collective_breakdown)
