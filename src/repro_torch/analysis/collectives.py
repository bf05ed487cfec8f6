"""The collectives a traced step issues, and the bytes each moves per device.

Counterpart of the JAX package's ``analysis/hlo_parse.py``, which reads them
out of compiled HLO.  Here they are recorded as they are dispatched: the
dry run's ``StepCounter`` (``launch.dryrun``) hands every dispatched op to
``dispatched_collective``, which knows the functional collectives DTensor
issues when it redistributes (all-gather, reduce-scatter, all-reduce,
all-to-all) and DTensor's shard-to-shard all-to-all, and a ``CollectiveLog``
sums them.  The bytes per device follow the reference's arithmetic, for a
group of n devices and a buffer of b bytes:

  all-gather        : out_bytes * (n-1)/n
  reduce-scatter    : in_bytes  * (n-1)/n
  all-reduce        : 2 * b * (n-1)/n     (ring = RS + AG)
  all-to-all        : b * (n-1)/n
  collective-permute: b

Unlike the HLO parse, every collective of the step is seen once per time it
runs (the port's loop over layers is unrolled), and each is attributed to
the mesh axis of its group, so that the roofline can price every axis's
link at its own bandwidth.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Tuple

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

# dispatched op name -> (kind, index of the group name among the arguments)
_OPS = {
    "_c10d_functional.all_gather_into_tensor": ("all-gather", 2),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", 3),
    "_c10d_functional.all_reduce": ("all-reduce", 2),
    "_c10d_functional.all_to_all_single": ("all-to-all", 3),
    "_dtensor.shard_dim_alltoall": ("all-to-all", 3),
}


def collective_bytes(kind: str, nbytes: float, n: int) -> float:
    """Bytes one device moves for a collective of ``kind`` over ``n`` devices
    on a buffer of ``nbytes`` (the output of an all-gather, the input of the
    others)."""
    if kind not in KINDS:
        raise ValueError(f"unknown collective {kind!r}")
    if kind == "collective-permute":
        return float(nbytes)
    frac = (n - 1) / n
    return (2.0 if kind == "all-reduce" else 1.0) * nbytes * frac


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    bytes_per_chip: float
    by_kind: Dict[str, float]
    by_axis: Dict[str, float] = dataclasses.field(default_factory=dict)

    def total(self) -> float:
        return self.bytes_per_chip


class CollectiveLog:
    """Collectives as (kind, buffer bytes, group size, mesh axis), summed
    into a ``CollectiveStats``."""

    def __init__(self) -> None:
        self.calls = []

    def record(self, kind: str, nbytes: float, n: int, axis: str = "") -> None:
        collective_bytes(kind, nbytes, n)      # validates the kind
        self.calls.append((kind, float(nbytes), int(n), axis))

    def stats(self) -> CollectiveStats:
        counts: Dict[str, int] = defaultdict(int)
        by_kind: Dict[str, float] = defaultdict(float)
        by_axis: Dict[str, float] = defaultdict(float)
        total = 0.0
        for kind, nbytes, n, axis in self.calls:
            eff = collective_bytes(kind, nbytes, n)
            counts[kind] += 1
            by_kind[kind] += eff
            by_axis[axis] += eff
            total += eff
        return CollectiveStats(dict(counts), total, dict(by_kind), dict(by_axis))


def mesh_groups(mesh) -> Dict[str, Tuple[str, int]]:
    """{process group name: (mesh axis, its size)} of every axis of a
    ``DeviceMesh``."""
    return {mesh.get_group(name).group_name: (name, mesh.size(i))
            for i, name in enumerate(mesh.mesh_dim_names)}


def nbytes(t) -> int:
    return t.numel() * t.element_size()


def dispatched_collective(func, args, out, groups: Dict[str, Tuple[str, int]]):
    """(kind, buffer bytes, group size, axis) of a dispatched collective, or
    None when ``func`` is not one.  A group outside ``groups`` raises."""
    name = str(func.overloadpacket) if hasattr(func, "overloadpacket") else str(func)
    name = name.replace("torch.ops.", "")
    hit = _OPS.get(name)
    if hit is None:
        return None
    kind, gi = hit
    group = args[gi]
    if group not in groups:
        raise KeyError(f"{name} over process group {group!r}, which is no axis of the mesh "
                       f"{sorted(v[0] for v in groups.values())}")
    axis, n = groups[group]
    buf = out if kind == "all-gather" else args[0]
    return kind, nbytes(buf), n, axis
