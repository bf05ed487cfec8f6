"""Quark-style secure container runtime (arXiv:2309.12624), modeled.

Quark runs containers on a user-space guest kernel (QKernel) behind a
lightweight hypervisor boundary (QVisor).  Lifecycle-wise it is
containerd-class — the provider still talks to a container runtime over
ms-scale RPCs and cold start pays container create *plus* a guest-kernel
boot — but every syscall and every packet crosses the interception layer,
so the datapath and execution overheads grow relative to plain
containers.  This occupies the "more isolation, same control plane"
corner of the backend trade-off space.

The port's copy of the JAX package's ``core/quark.py``.
"""
from __future__ import annotations

from repro_torch.core.backends import ColdStartModel, register_backend
from repro_torch.core.containerd import Containerd
from repro_torch.core.latency import (QUARK_COLDSTART_MS, QUARK_QUERY_MS,
                                      QUARK_RUNTIME, QUARK_STACK)


@register_backend
class Quark(Containerd):
    """Containerd-class lifecycle with per-syscall/datapath interception
    costs and a guest-kernel boot on the cold path."""

    name = "quark"
    runtime = QUARK_RUNTIME
    stack_costs = QUARK_STACK
    coldstart = ColdStartModel(deploy_ms=QUARK_COLDSTART_MS,
                               scale_factor=0.6,
                               query_ms=QUARK_QUERY_MS)
