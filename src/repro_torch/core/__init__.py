"""The faasd runtime with its six execution backends (containerd and
junctiond, the paper's pair, and the modeled quark, wasm, firecracker and
gvisor from related work), the controller's autoscaler and the multi-tenant
Zipf workload, as a deterministic discrete-event model on the host: the
port's own copy of the JAX package's ``repro.core`` for the closed loop that
``launch/serve.py`` drives (Fig 5) and the open loop, knee search and
sustainable throughput of Fig 6 (``drive``, ``KneeSearch``,
``sustainable_throughput``).  It is numpy, as in the JAX package, and runs
no kernel; the function body it deploys is timed on the card by the caller
and given as ``FunctionSpec.work_us``.
"""
from repro_torch.core.autoscaler import (Autoscaler, LeadTimePolicy,
                                         QueueDepthPolicy, ScaleEvent, ScalePolicy)
from repro_torch.core.backends import (ColdStartModel, ExecutionBackend,
                                       SnapshotColdStartModel,
                                       UnknownFunctionError, available_backends,
                                       get_backend_class, register_backend,
                                       resolve_backend)
from repro_torch.core.containerd import Containerd
from repro_torch.core.faas import (FaasdRuntime, FunctionSpec, InvocationPlan,
                                   InvocationRecord)
from repro_torch.core.firecracker import Firecracker, SnapshotCache
from repro_torch.core.gvisor import GVisor
from repro_torch.core.junction import JunctionInstance, UProc
from repro_torch.core.junctiond import Junctiond
from repro_torch.core.latency import AES_600B_WORK_US
from repro_torch.core.netstack import NetStack
from repro_torch.core.quark import Quark
from repro_torch.core.resources import CorePool
from repro_torch.core.scheduler import JunctionScheduler, PollingModel
from repro_torch.core.simulator import Event, EventLoop, Process, Queue, Simulator
from repro_torch.core.wasm import WasmSandbox
from repro_torch.core.workload import (ArrivalProcess, BurstyArrivals, ChainEdge,
                                       DiurnalArrivals, FusionPlan, KneeSearch,
                                       KneeSearchResult, LatencySummary, LoadSpec,
                                       NullObserver, PoissonArrivals, SimObserver,
                                       TraceReplay, drive, heavy_tailed_work,
                                       knee_index_of_curve, knee_of_curve, percentile,
                                       run_sequential, sustainable_throughput)

__all__ = [
    "AES_600B_WORK_US", "ArrivalProcess", "Autoscaler", "BurstyArrivals", "ChainEdge",
    "ColdStartModel", "Containerd", "CorePool", "DiurnalArrivals", "Event",
    "EventLoop", "ExecutionBackend", "FaasdRuntime", "Firecracker", "FunctionSpec",
    "FusionPlan", "GVisor", "InvocationPlan", "InvocationRecord", "JunctionInstance",
    "JunctionScheduler", "Junctiond", "KneeSearch", "KneeSearchResult", "LatencySummary",
    "LeadTimePolicy", "LoadSpec", "NetStack", "NullObserver", "PoissonArrivals",
    "PollingModel", "Process", "Quark", "Queue", "QueueDepthPolicy", "ScaleEvent",
    "ScalePolicy", "SimObserver", "Simulator", "SnapshotCache", "SnapshotColdStartModel",
    "TraceReplay", "UProc", "UnknownFunctionError", "WasmSandbox", "available_backends",
    "drive", "get_backend_class", "heavy_tailed_work", "knee_index_of_curve",
    "knee_of_curve", "percentile", "register_backend", "resolve_backend",
    "run_sequential", "sustainable_throughput",
]

# Opt-in runtime invariant checks (see repro_torch.analysis.sanitizer): with
# REPRO_SIM_CHECK=1 in the environment, every process importing the sim
# core runs with the checked EventLoop/CorePool wrappers installed.  The
# variable is the JAX package's too, so one switch checks both packages.
import os as _os

if _os.environ.get("REPRO_SIM_CHECK", "") not in ("", "0"):
    from repro_torch.analysis import sanitizer as _sanitizer
    _sanitizer.install()
