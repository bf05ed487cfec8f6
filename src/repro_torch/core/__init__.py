"""The faasd runtime with the paper's two execution backends, containerd
and junctiond (the paper's contribution), as a deterministic discrete-event
model on the host: the port's own copy of the JAX package's ``repro.core``
for the closed-loop path that ``launch/serve.py`` drives.  It is numpy, as
in the JAX package, and runs no kernel; the function body it deploys is
timed on the card by the caller and given as ``FunctionSpec.work_us``.
"""
from repro_torch.core.backends import (ColdStartModel, ExecutionBackend,
                                       UnknownFunctionError, available_backends,
                                       get_backend_class, register_backend,
                                       resolve_backend)
from repro_torch.core.containerd import Containerd
from repro_torch.core.faas import FaasdRuntime, FunctionSpec, InvocationRecord
from repro_torch.core.junction import JunctionInstance, UProc
from repro_torch.core.junctiond import Junctiond
from repro_torch.core.latency import AES_600B_WORK_US
from repro_torch.core.netstack import NetStack
from repro_torch.core.resources import CorePool
from repro_torch.core.scheduler import JunctionScheduler, PollingModel
from repro_torch.core.simulator import Event, Process, Queue, Simulator
from repro_torch.core.workload import LatencySummary, percentile, run_sequential

__all__ = [
    "AES_600B_WORK_US", "ColdStartModel", "Containerd", "CorePool", "Event",
    "ExecutionBackend", "FaasdRuntime", "FunctionSpec", "InvocationRecord",
    "JunctionInstance", "JunctionScheduler", "Junctiond", "LatencySummary",
    "NetStack", "PollingModel", "Process", "Queue", "Simulator", "UProc",
    "UnknownFunctionError", "available_backends", "get_backend_class",
    "percentile", "register_backend", "resolve_backend", "run_sequential",
]
