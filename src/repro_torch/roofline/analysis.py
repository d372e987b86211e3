"""Roofline analysis from compiled artifacts (assignment §ROOFLINE).

Three terms per (arch × shape × mesh), all in seconds:

    compute    = HLO_FLOPs / (chips × peak_FLOP/s)
    memory     = HLO_bytes / (chips × HBM_bw)
    collective = collective_bytes / (chips × link_bw)

HLO_FLOPs / HLO_bytes come from ``compiled.cost_analysis()``. Collective
bytes are parsed from the compiled HLO text: we sum the *output* operand
sizes of every all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute (output size ≈ bytes each participating device must
move for ring/torus algorithms, up to the 2(n−1)/n factor, which we fold
into the link-bandwidth derate).

Also reports MODEL_FLOPS = 6·N·D (6·N_active·D for MoE) and its ratio to
HLO_FLOPs (remat/redundancy waste detector).
"""

from __future__ import annotations

import dataclasses
import re

from repro_torch.core.power_model import TPU_V5E, HardwareSpec

__all__ = ["CollectiveStats", "RooflineReport", "parse_collective_bytes",
           "roofline_terms", "model_flops"]

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                   "collective-permute")

# e.g. "bf16[16,4096,128]{2,1,0}" or "f32[]"
_SHAPE_RE = re.compile(r"\b([a-z]+\d*)\[([\d,]*)\]")


def _shape_bytes(dtype: str, dims: str) -> int:
    nbytes = _DTYPE_BYTES.get(dtype)
    if nbytes is None:
        return 0
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * nbytes


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict[str, int]
    count_by_kind: dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


def parse_collective_bytes(hlo_text: str) -> CollectiveStats:
    """Sum output-shape bytes of every collective op in HLO text."""
    bytes_by: dict[str, int] = {k: 0 for k in _COLLECTIVE_OPS}
    count_by: dict[str, int] = {k: 0 for k in _COLLECTIVE_OPS}
    for line in hlo_text.splitlines():
        stripped = line.strip()
        # match instruction lines: "%name = TYPE[dims] op-name(...)"
        m = re.match(r"^[%\w.\-]+\s*=\s*(.+)$", stripped)
        if not m:
            continue
        rhs = m.group(1)
        opm = re.search(r"\b(" + "|".join(_COLLECTIVE_OPS)
                        + r")(?:-start|-done)?\(", rhs)
        if not opm:
            continue
        kind = opm.group(1)
        if "-done(" in rhs:   # avoid double counting start/done pairs
            continue
        # Output shape(s): everything before the op name. Tuples sum.
        head = rhs[:opm.start()]
        total = sum(_shape_bytes(d, dims)
                    for d, dims in _SHAPE_RE.findall(head))
        bytes_by[kind] += total
        count_by[kind] += 1
    return CollectiveStats(bytes_by, count_by)


def model_flops(n_params_active: int, n_tokens: int, *,
                training: bool = True) -> float:
    """6·N·D for a train step; 2·N·D for inference forward."""
    return (6.0 if training else 2.0) * n_params_active * n_tokens


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: int
    collectives: dict[str, int]
    collective_counts: dict[str, int]
    t_compute: float
    t_memory: float
    t_collective: float
    model_flops_: float
    bytes_per_device: int | None = None

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """compute-term / max-term: 1.0 ⇒ perfectly compute-bound."""
        return self.t_compute / self.bound_time if self.bound_time else 0.0

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops_ / self.hlo_flops if self.hlo_flops else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "roofline_fraction": self.roofline_fraction,
            "hlo_gflops": self.hlo_flops / 1e9,
            "hlo_gbytes": self.hlo_bytes / 1e9,
            "coll_gbytes": self.collective_bytes / 1e9,
            "model_flops_ratio": self.useful_flops_ratio,
            "bytes_per_device": self.bytes_per_device,
        }


def roofline_terms(*, arch: str, shape: str, mesh_name: str, chips: int,
                   cost_analysis: dict, hlo_text: str,
                   n_params_active: int, n_tokens: int, training: bool,
                   bytes_per_device: int | None = None,
                   hw: HardwareSpec = TPU_V5E) -> RooflineReport:
    """Build the three-term report from a compiled dry-run artifact.

    SEMANTICS (measured, see tests): ``compiled.cost_analysis()`` on an
    SPMD module reports **per-device** flops/bytes, and the compiled HLO
    text is the per-device program (collective output shapes are
    per-device). So the assignment's formulas

        compute    = HLO_FLOPs   / (chips × peak)
        memory     = HLO_bytes   / (chips × HBM_bw)
        collective = coll_bytes  / (chips × link_bw)

    are applied with HLO_* = per-device value × chips — equivalently,
    per-device value / per-chip rate.
    """
    flops_dev = float(cost_analysis.get("flops", 0.0))
    hbm_dev = float(cost_analysis.get("bytes accessed", 0.0))
    coll = parse_collective_bytes(hlo_text)   # per-device module
    t_compute = flops_dev / hw.peak_flops_bf16
    t_memory = hbm_dev / hw.hbm_bandwidth
    t_coll = coll.total_bytes / hw.ici_bandwidth_per_link
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=flops_dev * chips, hlo_bytes=hbm_dev * chips,
        collective_bytes=coll.total_bytes,
        collectives=coll.bytes_by_kind, collective_counts=coll.count_by_kind,
        t_compute=t_compute, t_memory=t_memory, t_collective=t_coll,
        model_flops_=model_flops(n_params_active, n_tokens,
                                 training=training),
        bytes_per_device=bytes_per_device,
    )
