"""The faasd runtime with the paper's two execution backends, containerd
and junctiond (the paper's contribution), as a deterministic discrete-event
model on the host: the port's own copy of the JAX package's ``repro.core``
for the closed loop that ``launch/serve.py`` drives (Fig 5) and the open
loop, knee search and sustainable throughput of Fig 6 (``drive``,
``KneeSearch``, ``sustainable_throughput``).  It is numpy, as in the JAX
package, and runs no kernel; the function body it deploys is timed on the
card by the caller and given as ``FunctionSpec.work_us``.
"""
from repro_torch.core.backends import (ColdStartModel, ExecutionBackend,
                                       UnknownFunctionError, available_backends,
                                       get_backend_class, register_backend,
                                       resolve_backend)
from repro_torch.core.containerd import Containerd
from repro_torch.core.faas import (FaasdRuntime, FunctionSpec, InvocationPlan,
                                   InvocationRecord)
from repro_torch.core.junction import JunctionInstance, UProc
from repro_torch.core.junctiond import Junctiond
from repro_torch.core.latency import AES_600B_WORK_US
from repro_torch.core.netstack import NetStack
from repro_torch.core.resources import CorePool
from repro_torch.core.scheduler import JunctionScheduler, PollingModel
from repro_torch.core.simulator import Event, EventLoop, Process, Queue, Simulator
from repro_torch.core.workload import (ArrivalProcess, BurstyArrivals, ChainEdge,
                                       DiurnalArrivals, FusionPlan, KneeSearch,
                                       KneeSearchResult, LatencySummary, LoadSpec,
                                       NullObserver, PoissonArrivals, SimObserver,
                                       TraceReplay, drive, heavy_tailed_work,
                                       knee_index_of_curve, knee_of_curve, percentile,
                                       run_sequential, sustainable_throughput)

__all__ = [
    "AES_600B_WORK_US", "ArrivalProcess", "BurstyArrivals", "ChainEdge",
    "ColdStartModel", "Containerd", "CorePool", "DiurnalArrivals", "Event",
    "EventLoop", "ExecutionBackend", "FaasdRuntime", "FunctionSpec", "FusionPlan",
    "InvocationPlan", "InvocationRecord", "JunctionInstance", "JunctionScheduler",
    "Junctiond", "KneeSearch", "KneeSearchResult", "LatencySummary", "LoadSpec",
    "NetStack", "NullObserver", "PoissonArrivals", "PollingModel", "Process",
    "Queue", "SimObserver", "Simulator", "TraceReplay", "UProc",
    "UnknownFunctionError", "available_backends", "drive", "get_backend_class",
    "heavy_tailed_work", "knee_index_of_curve", "knee_of_curve", "percentile",
    "register_backend", "resolve_backend", "run_sequential",
    "sustainable_throughput",
]
