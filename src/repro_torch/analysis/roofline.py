"""Three-term roofline of a dry-run trace, per device, against one H100:

    compute_term    = flops / 989 TFLOP/s              (dense bf16)
    memory_term     = bytes accessed / 3.35 TB/s       (HBM3)
    collective_term = sum over mesh axes of that axis's collective bytes
                      over its link: NVLink 450 GB/s each way for 'model',
                      the node's network, 50 GB/s a card, for 'data', 'pod'

The constants are ``launch.mesh``'s, NVIDIA's data-sheet figures at 700 W:
the terms are predictions, not measurements.  Counterpart of the JAX
package's ``analysis/roofline.py``, with ``probe_from_trace`` in place of
``probe_from_compiled``.

The counts come from ``launch.dryrun``'s trace of the port's plain path on
DTensors: flops are the local shards' operations (the per-device count),
and bytes accessed are what every ATen op of the trace reads and writes,
unfused, which over-counts against a fused compiler's figure.  The port's
loop over layers is unrolled, so a full-depth trace counts every layer; the
two probe depths and ``extrapolate`` stay for what they save in trace time
on deep stacks.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.launch.mesh import AXIS_BW, HBM_BW, PEAK_FLOPS_BF16


@dataclasses.dataclass
class ProbePoint:
    layers: int
    flops: float            # per device
    bytes_accessed: float   # per device
    coll_bytes: float       # per device
    coll_by_axis: Dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-device totals per step
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    # the three terms (seconds)
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float      # 6ND / 2ND analytic (global)
    useful_ratio: float     # model_flops / (hlo_flops * chips)
    step_time_s: float      # max of the three terms
    memory_per_chip_gb: Optional[float] = None
    notes: str = ""
    coll_by_axis: Dict[str, float] = dataclasses.field(default_factory=dict)

    def as_row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "compute_ms": self.compute_s * 1e3,
            "memory_ms": self.memory_s * 1e3,
            "collective_ms": self.collective_s * 1e3,
            "bottleneck": self.bottleneck,
            "useful_ratio": self.useful_ratio,
            "step_ms": self.step_time_s * 1e3,
            "mem_gb": self.memory_per_chip_gb,
        }


def extrapolate(pa: ProbePoint, pb: ProbePoint, layers: int):
    """Linear fit through two probe points, evaluated at `layers`."""
    dl = pb.layers - pa.layers
    assert dl > 0

    def fit(a, b):
        per_layer = (b - a) / dl
        base = a - pa.layers * per_layer
        return base + layers * per_layer, per_layer

    flops, flops_pl = fit(pa.flops, pb.flops)
    byts, _ = fit(pa.bytes_accessed, pb.bytes_accessed)
    coll, coll_pl = fit(pa.coll_bytes, pb.coll_bytes)
    axes = sorted(set(pa.coll_by_axis) | set(pb.coll_by_axis))
    by_axis = {a: max(fit(pa.coll_by_axis.get(a, 0.0), pb.coll_by_axis.get(a, 0.0))[0], 0.0)
               for a in axes}
    return {"flops": max(flops, pb.flops), "bytes": max(byts, pb.bytes_accessed),
            "coll": max(coll, 0.0), "coll_by_axis": by_axis,
            "flops_per_layer": flops_pl, "coll_per_layer": coll_pl}


def probe_from_trace(layers: int, counts: Dict) -> ProbePoint:
    """A probe point from ``dryrun.trace``'s counts."""
    return ProbePoint(layers=layers, flops=float(counts["flops"]),
                      bytes_accessed=float(counts["bytes"]),
                      coll_bytes=float(counts["collectives"].bytes_per_chip),
                      coll_by_axis=dict(counts["collectives"].by_axis))


def collective_seconds(by_axis: Dict[str, float], coll: float) -> float:
    """Each axis's bytes over its link; bytes of no named axis (a stats
    object without the split) at the slowest link."""
    named = sum(by_axis.values())
    t = sum(b / AXIS_BW[a] for a, b in by_axis.items())
    rest = max(coll - named, 0.0)
    return t + rest / min(AXIS_BW.values())


def build_roofline(arch: str, shape: str, mesh_name: str, chips: int,
                   totals: Dict[str, float], model_flops: float,
                   memory_per_chip_gb: Optional[float] = None,
                   notes: str = "") -> Roofline:
    by_axis = dict(totals.get("coll_by_axis", {}))
    compute_s = totals["flops"] / PEAK_FLOPS_BF16
    memory_s = totals["bytes"] / HBM_BW
    collective_s = collective_seconds(by_axis, totals["coll"])
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    useful = model_flops / max(1.0, totals["flops"] * chips)
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=totals["flops"], hlo_bytes=totals["bytes"],
        coll_bytes=totals["coll"],
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=bottleneck, model_flops=model_flops,
        useful_ratio=useful, step_time_s=max(terms.values()),
        memory_per_chip_gb=memory_per_chip_gb, notes=notes, coll_by_axis=by_axis)
