"""Wasm-style lightweight FaaS sandbox (arXiv:2010.07115, WasmEdge-class),
modeled.

Functions are WebAssembly modules instantiated in-process from a compiled
image: cold start is sub-millisecond and OS interactions go through a
thin WASI shim, but the compute itself pays a moderate AOT/JIT overhead
versus native code, and networking still rides the kernel stack.  This
occupies the "instant cold start, moderate datapath" corner of the
backend trade-off space — the opposite bet from quark.

The port's copy of the JAX package's ``core/wasm.py``.  ``work_mult``
(1.35) scales ``FunctionSpec.work_us`` as it does there: a body the card
measured at 100 µs is charged 135 µs inside the sandbox.
"""
from __future__ import annotations

from repro_torch.core.backends import ColdStartModel, register_backend
from repro_torch.core.containerd import Containerd
from repro_torch.core.latency import (KERNEL_STACK, WASM_COLDSTART_MS,
                                      WASM_QUERY_MS, WASM_RUNTIME)


@register_backend
class WasmSandbox(Containerd):
    """Container-shaped lifecycle with sub-ms instantiation and a
    work-multiplier on the function body (interpreted/JIT compute)."""

    name = "wasm"
    runtime = WASM_RUNTIME
    stack_costs = KERNEL_STACK
    coldstart = ColdStartModel(deploy_ms=WASM_COLDSTART_MS,
                               scale_factor=0.5,
                               query_ms=WASM_QUERY_MS)
