"""Fleet-scale simulation: gateway + N-worker cluster + provisioning.

Promotes the single ``FaasdRuntime`` to a simulated fleet (see
ROADMAP "Fleet"): a :class:`Cluster` of N per-worker runtimes behind a
:class:`Gateway` with pluggable placement, plus FaaSNet-style
function-image distribution charging provisioning storms.  Drive it
like any runtime: ``drive(cluster, load)``.

The port's copy of the JAX package's ``fleet/__init__.py``.
"""

from repro_torch.fleet.cluster import Cluster, Worker
from repro_torch.fleet.gateway import Gateway
from repro_torch.fleet.placement import (LeastLoadedPlacement, LocalityPlacement,
                                         PlacementPolicy, RoundRobinPlacement,
                                         available_placements, register_placement,
                                         resolve_placement)
from repro_torch.fleet.provisioning import (FaasNetTree, ImageDistribution,
                                            NaiveRegistryPull, PullRecord,
                                            SharedLink, available_distributions,
                                            register_distribution,
                                            resolve_distribution)

__all__ = [
    "Cluster",
    "Worker",
    "Gateway",
    "PlacementPolicy",
    "RoundRobinPlacement",
    "LeastLoadedPlacement",
    "LocalityPlacement",
    "register_placement",
    "resolve_placement",
    "available_placements",
    "ImageDistribution",
    "NaiveRegistryPull",
    "FaasNetTree",
    "SharedLink",
    "PullRecord",
    "register_distribution",
    "resolve_distribution",
    "available_distributions",
]
