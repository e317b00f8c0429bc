"""Roofline terms of one rank's program, from its op stream.

The port of ``src/repro/launch/roofline.py``.  Three terms per (arch x
shape x mesh), in seconds, all per rank (the walk traces one rank's
program, :mod:`repro_torch.launch.op_walk`):

    compute    = each op's operations over the card's peak for its type
    memory     = bytes the ops read and write / HBM rate
    collective = valid collective bytes / the rate of the slowest link
                 each collective's group crosses

plus the *exposed* collective term, which charges only the collectives the
walk classifies serialized (:meth:`OpStats.exposed_collective_bytes`):

    collective_exposed = serialized valid bytes / their link rates

``roofline_fraction`` charges the exposed term: a double-buffered ring
whose transfers all classify overlapped pays no collective time.

Byte counts of a collective (the reference's walker's): its result bytes
once, an all-reduce's twice (reduce and broadcast phases); ``valid_fractions``
discount the padding of ragged (v-collective) transfers.

The constants are NVIDIA's data sheet for the card the port runs on,
**NVIDIA H100 80GB HBM3 (SXM), power limit 700.00 W**, dense rates: a card
set below 700 W runs slower than this model says.  Every number built on
them is a prediction for that card, never a measurement.  The links: NVLink
within a node of 8 GPUs, one 400 Gb/s NIC a GPU across nodes; ranks lie
row-major over nodes, so a 16-wide ``model`` axis spans two nodes.

The peak rates and the port's kernels' work formulas are
:mod:`repro_torch.kernels.work`'s; :func:`gemm_bound` is the GEMM kernels'
least time from them (``chip_smoke.py``'s ``bound``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import work
from repro_torch.kernels.work import gemm_work, peak_seconds

__all__ = ["HW", "CARD", "link_rate", "RooflineResult", "roofline_report", "gemm_bound"]

CARD = "NVIDIA H100 80GB HBM3, 700.00 W, data sheet"

# NVIDIA H100 80GB HBM3 (SXM) at 700.00 W, data sheet (dense rates)
HW = {
    "card": "NVIDIA H100 80GB HBM3",
    "power_limit_w": 700.0,
    "source": "data sheet",
    "peak_flops": work.BF16_FLOPS,  # bf16 / fp16 on the tensor cores
    "bf16_flops": work.BF16_FLOPS,
    "tf32_flops": work.TF32_FLOPS,  # TF32 on the tensor cores
    "fp32_flops": work.FP32_FLOPS,  # float32 outside the tensor cores (TF32 off)
    "hbm_bw": work.HBM_BW,  # bytes/s
    "hbm_bytes": 80e9,
    "nvlink_bw": 450e9,  # bytes/s a direction, within a node of 8 GPUs
    "net_bw": 50e9,  # bytes/s a GPU across nodes (one 400 Gb/s NIC a GPU)
    "gpus_per_node": 8,
}


def link_rate(ranks) -> float:
    """Bytes/s of the slowest link a group of global ``ranks`` crosses:
    NVLink when they share a node, the network otherwise."""
    nodes = {int(r) // HW["gpus_per_node"] for r in ranks}
    return HW["nvlink_bw"] if len(nodes) <= 1 else HW["net_bw"]


# ------------------------------------------------------- the GEMM bound ----

def gemm_bound(m: int, n: int, k: int, *, acc: bool, dtype=torch.float32, out_bytes: int = 4,
               acc_bytes: int = 4) -> tuple[float, str, float]:
    """``(ms, "bytes" | "operations", fp32_ms)``: the least time of the GEMM
    kernels' work (``chip_smoke.py``'s ``bound``): bytes (A and B in
    ``dtype`` read once, the output and acc in their own widths) over the
    HBM rate against the operations over their peak, whichever is larger
    (float32 operands: three TF32 products; bf16: one bf16 product); and
    beside it the float32 CUDA-core bound."""
    flops, nbytes = gemm_work(m, n, k, acc=acc, dtype=dtype, out_bytes=out_bytes,
                              acc_bytes=acc_bytes)
    t_bytes = nbytes / HW["hbm_bw"]
    t_ops = peak_seconds(2 * m * n * k, "split_tf32" if dtype == torch.float32 else dtype) \
        + (m * n / HW["fp32_flops"] if acc else 0)
    t_fp32 = flops / HW["fp32_flops"]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations",
            max(t_bytes, t_fp32) * 1e3)


# ------------------------------------------------------------- roofline ----

@dataclasses.dataclass
class RooflineResult:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float  # this rank's operations (the reference's field name)
    hlo_bytes: float  # this rank's bytes read and written
    coll_bytes: float  # wire bytes (includes ragged padding)
    coll_by_op: dict
    model_flops: float
    t_compute: float
    t_memory: float
    t_collective: float  # valid-payload wire time (padding discounted)
    permutes_overlapped: int = 0
    permutes_serialized: int = 0
    permute_overlap_fraction: float | None = None
    collectives_overlapped: int = 0
    collectives_serialized: int = 0
    collective_overlap_fraction: float | None = None
    coll_exposed_bytes: float = 0.0
    t_collective_exposed: float = 0.0
    coll_overlap_by_kind: dict = dataclasses.field(default_factory=dict)
    coll_valid_bytes: float = 0.0

    @property
    def dominant(self) -> str:
        """The binding term of the modeled step, the collective term at its
        *exposed* time (as ``roofline_fraction`` charges it)."""
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective_exposed,
        }
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / (chips * this rank's operations): how much of the
        traced compute is useful 6ND math (catches recompute and
        redundancy)."""
        total = self.chips * self.hlo_flops
        return self.model_flops / total if total else float("nan")

    @property
    def roofline_fraction(self) -> float:
        """Ideal useful-math time (MODEL_FLOPS over all chips at the bf16
        peak) over the modeled step time (the largest of the three terms,
        the collective one at its exposed time); 1.0 is the card's
        ceiling."""
        t_ideal = (self.model_flops / self.chips) / HW["peak_flops"]
        t_actual = max(self.t_compute, self.t_memory, self.t_collective_exposed)
        return t_ideal / t_actual if t_actual else float("nan")

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(dominant=self.dominant, useful_ratio=self.useful_ratio,
                 roofline_fraction=self.roofline_fraction, card=CARD)
        return d


def roofline_report(*, arch: str, shape: str, mesh_name: str, chips: int, stats,
                    model_flops: float) -> RooflineResult:
    """The roofline of one rank's traced program from its
    :class:`repro_torch.launch.op_walk.OpStats` (every quantity per rank
    and per step; the walk saw every iteration)."""
    exposed = stats.exposed_collective_bytes()
    return RooflineResult(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        chips=chips,
        hlo_flops=stats.flops,
        hlo_bytes=stats.bytes,
        coll_bytes=stats.collective_bytes,
        coll_by_op={k: float(v) for k, v in stats.coll_by_op.items()},
        model_flops=model_flops,
        t_compute=stats.compute_seconds,
        t_memory=stats.bytes / HW["hbm_bw"],
        t_collective=sum(c.payload_bytes * c.factor / c.link_rate for c in stats.collectives),
        permutes_overlapped=stats.collectives_overlapped("collective-permute"),
        permutes_serialized=stats.collectives_serialized("collective-permute"),
        permute_overlap_fraction=stats.overlap_fraction("collective-permute"),
        collectives_overlapped=stats.collectives_overlapped(),
        collectives_serialized=stats.collectives_serialized(),
        collective_overlap_fraction=stats.overlap_fraction(),
        coll_exposed_bytes=exposed,
        t_collective_exposed=sum(c.exposed_bytes / c.link_rate for c in stats.collectives),
        coll_overlap_by_kind=stats.overlap_by_kind(),
        coll_valid_bytes=stats.valid_collective_bytes,
    )
