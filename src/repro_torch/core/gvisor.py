"""gVisor-style sandboxed container runtime (runsc), modeled.

Functions run behind the Sentry — a user-space kernel written in Go that
intercepts every syscall and owns a user-space netstack.  The control
plane is containerd-shaped (runsc is an OCI runtime), but the cold start
is lighter than a container-on-VM or quark's guest-kernel boot: the
Sentry comes up without booting a Linux guest.  Warm-path costs land
between ``containerd`` and ``quark``: every syscall and every packet pay
the interception tax, but less than quark's full QKernel/QVisor stack.

The ``platform`` knob picks how interception happens, mirroring runsc's
``--platform`` flag:

* ``"kvm"`` (default) — syscalls trap via lightweight VM exits; the
  registered cost tables.
* ``"ptrace"`` — every syscall costs two context switches through the
  ptrace stop machinery; several times more per-syscall overhead and a
  slower netstack (the portable-but-slow fallback).

Both platforms share the lifecycle and cold-start class; only the cost
tables differ, so the knob is a constructor argument rather than a second
registry entry.

The port's copy of the JAX package's ``core/gvisor.py``.
"""
from __future__ import annotations

from repro_torch.core.backends import ColdStartModel, register_backend
from repro_torch.core.containerd import Containerd
from repro_torch.core.latency import (GVISOR_COLDSTART_MS, GVISOR_KVM_RUNTIME,
                                      GVISOR_KVM_STACK, GVISOR_PTRACE_RUNTIME,
                                      GVISOR_PTRACE_STACK, GVISOR_QUERY_MS)
from repro_torch.core.scheduler import PollingModel
from repro_torch.core.simulator import Simulator


@register_backend
class GVisor(Containerd):
    """Containerd-class lifecycle with Sentry syscall/netstack interception
    costs; ``platform`` selects the KVM or ptrace cost tables."""

    name = "gvisor"
    runtime = GVISOR_KVM_RUNTIME
    stack_costs = GVISOR_KVM_STACK
    coldstart = ColdStartModel(deploy_ms=GVISOR_COLDSTART_MS,
                               scale_factor=0.6,
                               query_ms=GVISOR_QUERY_MS)

    PLATFORMS = {
        "kvm": (GVISOR_KVM_RUNTIME, GVISOR_KVM_STACK),
        "ptrace": (GVISOR_PTRACE_RUNTIME, GVISOR_PTRACE_STACK),
    }

    def __init__(self, sim: Simulator, *, n_cores: int = 10,
                 polling_model: PollingModel = PollingModel.CENTRALIZED,
                 platform: str = "kvm"):
        try:
            runtime, stack = self.PLATFORMS[platform]
        except KeyError:
            raise ValueError(
                f"unknown gVisor platform {platform!r}; "
                f"have {sorted(self.PLATFORMS)}") from None
        self.platform = platform
        # instance attributes shadow the class-level (kvm) cost tables
        # before the base constructor builds the CorePool/NetStack from them
        self.runtime = runtime
        self.stack_costs = stack
        super().__init__(sim, n_cores=n_cores, polling_model=polling_model)
