"""Pluggable execution backends for the faasd runtime.

The paper's core move is swapping faasd's execution backend (containerd →
junctiond); this module makes the backend a first-class, registered
abstraction instead of an if/else in :class:`~repro_torch.core.faas.FaasdRuntime`.

An :class:`ExecutionBackend` bundles everything the runtime needs from a
backend:

* **cost tables** — a :class:`~repro_torch.core.latency.RuntimeCosts` (per-hop
  application processing, execution overheads, thrash model) and a
  :class:`~repro_torch.core.latency.StackCosts` (the network datapath);
* **host resources** — the :class:`~repro_torch.core.resources.CorePool`, an
  optional core scheduler (junctiond's centralized poller), and the
  :class:`~repro_torch.core.netstack.NetStack` built from the cost tables;
* **a cold-start model** — :class:`ColdStartModel` with the deploy /
  scale / control-plane-query timing class;
* **the control-plane lifecycle** — ``deploy`` / ``scale`` / ``query`` /
  ``remove`` / ``lookup``, with uniform error behaviour
  (:class:`UnknownFunctionError` on lifecycle ops addressing undeployed
  functions, ``None`` from reads).

Implementations register under a unique name with ``@register_backend``;
:func:`resolve_backend` turns a name (via the registry) or a ready
instance into the bundle ``FaasdRuntime`` composes with.  Adding a
backend therefore never touches ``faas.py``.

The port's copy of the JAX package's ``core/backends.py``.  It has the
paper's pair, ``containerd`` and ``junctiond``; the JAX package's four
modeled backends from related work (``quark``, ``wasm``, ``firecracker``,
``gvisor``) are not ported yet, and asking for one raises ``ValueError``
naming the ROADMAP item that ports it.
"""
from __future__ import annotations

import abc
import dataclasses
import importlib
from typing import Dict, Generator, Optional, Tuple, Type, Union

from repro_torch.core.latency import RuntimeCosts, StackCosts
from repro_torch.core.netstack import NetStack
from repro_torch.core.resources import CorePool
from repro_torch.core.scheduler import PollingModel
from repro_torch.core.simulator import Simulator


class UnknownFunctionError(KeyError):
    """A lifecycle operation addressed a function the backend has not
    deployed.  Raised uniformly by every backend (the conformance tests
    pin this), so callers never need backend-specific error handling."""

    def __init__(self, backend: str, fn_name: str):
        super().__init__(fn_name)
        self.backend = backend
        self.fn_name = fn_name

    def __str__(self) -> str:
        return (f"backend {self.backend!r} has no deployed function "
                f"{self.fn_name!r}")


@dataclasses.dataclass(frozen=True)
class ColdStartModel:
    """Control-plane timing class of a backend.

    ``deploy_ms`` is sandbox/instance creation until first-invoke ready
    (container create+start, Junction instance init, Wasm instantiate);
    ``scale_factor`` is the marginal cost of one additional replica as a
    fraction of a full deploy; ``query_ms`` is the control-plane state
    query the provider cache keeps off the warm path (paper §4).
    """
    deploy_ms: float
    scale_factor: float
    query_ms: float

    @property
    def deploy_seconds(self) -> float:
        return self.deploy_ms * 1e-3

    @property
    def scale_seconds(self) -> float:
        return self.deploy_ms * self.scale_factor * 1e-3

    @property
    def query_seconds(self) -> float:
        return self.query_ms * 1e-3


class ExecutionBackend(abc.ABC):
    """One execution backend: cost tables + host resources + lifecycle.

    Subclasses set the four class attributes and implement the lifecycle;
    ``_build_scheduler``/``_start_services`` are wiring hooks for backends
    that reserve cores or run runtime services inside their own sandboxes
    (junctiond does both).
    """

    # -- identity + cost tables (class attributes on implementations) -----
    name: str = ""                      # unique registry key
    runtime: RuntimeCosts
    stack_costs: StackCosts
    coldstart: ColdStartModel

    def __init__(self, sim: Simulator, *, n_cores: int = 10,
                 polling_model: PollingModel = PollingModel.CENTRALIZED):
        self.sim = sim
        self.cores = CorePool(sim, n_cores, self.runtime)
        self.scheduler = self._build_scheduler(polling_model)
        self.stack = NetStack(sim, self.stack_costs, self.cores)
        self.records: Dict[str, object] = {}
        self.deploys = 0
        self._start_services()

    # -- wiring hooks -----------------------------------------------------
    def _build_scheduler(self, polling_model: PollingModel):
        """Core scheduler for this backend; None means host CFS."""
        return None

    def _start_services(self) -> None:
        """Bring up the faasd runtime services (gateway/provider) if the
        backend hosts them in its own sandboxes."""

    # -- control-plane lifecycle -----------------------------------------
    @abc.abstractmethod
    def deploy(self, fn_name: str, *, scale: int = 1, max_cores: int = 2,
               isolate_replicas: bool = False) -> Generator:
        """Process: create the function's sandbox(es); yields until ready.
        Re-deploying an existing name first releases the old *runtime*
        resources (sandboxes, scheduler registrations — as :meth:`remove`
        would) so config updates never leak."""

    @abc.abstractmethod
    def scale(self, fn_name: str, replicas: int) -> Generator:
        """Process: adjust the replica count of a **deployed** function.
        Must raise :class:`UnknownFunctionError` for undeployed names."""

    def remove(self, fn_name: str) -> None:
        """Tear down the function and release every resource it held.
        Removing an unknown function is a no-op (idempotent teardown)."""
        self.records.pop(fn_name, None)

    def query(self, fn_name: str) -> Generator:
        """Process: control-plane state query (GetTask/Status RPC class);
        returns the record, or None for unknown names."""
        yield self.sim.timeout(self.coldstart.query_seconds)
        return self.records.get(fn_name)

    def lookup(self, fn_name: str):
        """Zero-cost read of the backend's record (provider-cache fill)."""
        return self.records.get(fn_name)

    # -- shared helpers ---------------------------------------------------
    @property
    def query_seconds(self) -> float:
        return self.coldstart.query_seconds

    def _require(self, fn_name: str):
        try:
            return self.records[fn_name]
        except KeyError:
            raise UnknownFunctionError(self.name, fn_name) from None


# ---------------------------------------------------------------------------
# Registry.

_REGISTRY: Dict[str, Type[ExecutionBackend]] = {}

# Modules that register the built-in backends on import.  Imported lazily
# (the implementations import this module for the base class).
_BUILTIN_MODULES = (
    "repro_torch.core.containerd",
    "repro_torch.core.junctiond",
)

# Backends of the JAX package that the port does not have yet.
_NOT_PORTED = ("quark", "wasm", "firecracker", "gvisor")


def register_backend(cls: Type[ExecutionBackend]) -> Type[ExecutionBackend]:
    """Class decorator: register ``cls`` under ``cls.name``."""
    name = getattr(cls, "name", "")
    if not name:
        raise ValueError(f"{cls.__qualname__} must set a non-empty `name`")
    existing = _REGISTRY.get(name)
    if existing is not None and existing is not cls:
        raise ValueError(f"backend name {name!r} already registered by "
                         f"{existing.__qualname__}")
    _REGISTRY[name] = cls
    return cls


def _ensure_builtins() -> None:
    for mod in _BUILTIN_MODULES:
        importlib.import_module(mod)


def available_backends() -> Tuple[str, ...]:
    """Sorted names of every registered backend."""
    _ensure_builtins()
    return tuple(sorted(_REGISTRY))


def get_backend_class(name: str) -> Type[ExecutionBackend]:
    _ensure_builtins()
    if name in _NOT_PORTED and name not in _REGISTRY:
        raise ValueError(f"backend {name!r} is not ported yet (ROADMAP.md, "
                         "queue 1 item 6c); ported backends: "
                         f"{', '.join(sorted(_REGISTRY))}")
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown backend {name!r}; registered backends: "
                         f"{', '.join(sorted(_REGISTRY))}") from None


def resolve_backend(backend: Union[str, ExecutionBackend], sim: Simulator, *,
                    n_cores: Optional[int] = None,
                    polling_model: Optional[PollingModel] = None,
                    ) -> ExecutionBackend:
    """Name (via the registry) or ready instance -> attached backend.

    A ready instance must already be bound to ``sim`` and fully
    configured; passing ``n_cores``/``polling_model`` alongside one is
    rejected rather than silently ignored.
    """
    if isinstance(backend, ExecutionBackend):
        if backend.sim is not sim:
            raise ValueError(
                f"backend instance {backend.name!r} is bound to a different "
                "Simulator; build it on the runtime's simulator")
        if n_cores is not None or polling_model is not None:
            raise ValueError(
                "n_cores/polling_model cannot be applied to a ready backend "
                "instance; configure the instance at construction instead")
        return backend
    # only pass what the caller actually set, so a backend class remains
    # the single source of its own constructor defaults
    kwargs = {}
    if n_cores is not None:
        kwargs["n_cores"] = n_cores
    if polling_model is not None:
        kwargs["polling_model"] = polling_model
    return get_backend_class(backend)(sim, **kwargs)
