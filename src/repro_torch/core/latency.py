"""Calibrated per-operation cost constants for the two datapaths.

The port's copy of the JAX package's ``core/latency.py``, holding the
tables of the two backends ported so far (containerd and junctiond).  They
are the paper's x86 host costs: nothing here was measured on a GPU.

Values are literature-grounded (µs scale):

* syscall entry/exit ~0.5–1.5 µs (post-KPTI x86) — [Junction §2, IX, Demikernel]
* kernel TCP tx/rx processing ~3–8 µs/packet — [mTCP, IX]
* interrupt + softirq + thread wakeup (ctx switch + run-queue delay)
  ~10–25 µs under background load — [Caladan §2]
* CFS/GC/timer "hiccups" of 1–3 ms with small probability drive the
  kernel-path tail — [Shinjuku, Caladan]
* Junction: user-space stack ~1 µs, NIC doorbell/DMA ~0.6 µs, centralized
  scheduler poll pickup <0.5 µs, preemption bounded — [Junction §4/§5]
* Junction instance cold init = 3.4 ms — **measured in the paper (§5)**.

The *relative* end-to-end numbers these produce are validated against the
paper's claims by the JAX package's ``benchmarks/fig5_latency.py`` and
``fig6_load.py``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class StackCosts:
    """One-way message costs for one network traversal."""
    name: str
    # latency-only components (seconds)
    send_lat_us: float        # syscall + tx processing (sender side, also CPU)
    wire_us: float            # NIC + wire + switch
    rx_lat_us: float          # rx processing before app sees data
    wakeup_us: float          # interrupt->softirq->scheduler wakeup (kernel)
                              # or poll pickup + uthread dispatch (junction)
    # CPU consumed on the host per message (seconds of core time)
    tx_cpu_us: float
    rx_cpu_us: float
    wakeup_cpu_us: float      # context switch cost (kernel) / dispatch (junction)
    per_kb_us: float          # serialization+copy per KiB (zero-copy for junction)
    # tail behaviour
    jitter_sigma: float       # lognormal sigma on processing
    hiccup_p: float           # P(scheduling/GC hiccup) per message
    hiccup_lo_ms: float
    hiccup_hi_ms: float


KERNEL_STACK = StackCosts(
    name="kernel",
    send_lat_us=5.0,      # sendmsg syscall 1.0 + TCP/IP tx 4.0
    wire_us=1.0,
    rx_lat_us=6.0,        # softirq rx processing
    wakeup_us=15.0,       # interrupt + wake + run-queue delay
    tx_cpu_us=5.0, rx_cpu_us=6.0, wakeup_cpu_us=3.0,
    per_kb_us=0.6,
    jitter_sigma=0.30,
    hiccup_p=0.010, hiccup_lo_ms=0.7, hiccup_hi_ms=2.2,
)

JUNCTION_STACK = StackCosts(
    name="junction",
    send_lat_us=1.0,      # user-space stack, function-call "syscall"
    wire_us=1.0,
    rx_lat_us=0.6,        # DMA into user memory
    wakeup_us=0.7,        # poll pickup + uthread dispatch
    tx_cpu_us=0.9, rx_cpu_us=0.5, wakeup_cpu_us=0.3,
    per_kb_us=0.15,       # zero-copy path
    jitter_sigma=0.15,
    hiccup_p=0.009, hiccup_lo_ms=0.1, hiccup_hi_ms=0.65,
)


@dataclasses.dataclass(frozen=True)
class RuntimeCosts:
    """Per-component application processing (µs of CPU on the critical
    path) and function-execution overheads."""
    name: str
    gateway_us: float          # auth + route + proxy (Go, HTTP/2)
    provider_us: float         # resolve + proxy
    watchdog_us: float         # of-watchdog style in-instance request fanout
    exec_syscall_overhead_us: float   # OS interactions during function body
    exec_hiccup_p: float       # hiccup during execution (GC/CFS preempt)
    exec_hiccup_lo_ms: float
    exec_hiccup_hi_ms: float
    app_jitter_sigma: float
    # scheduling-thrash model: effective CPU multiplier grows with
    # (runnable backlog / cores); bounded.  Kernel CFS thrashes (cache
    # pollution, migrations); Junction runs-to-completion.
    thrash_coeff: float
    thrash_cap: float
    # CPU burned per request OFF the critical path (GC cycles, goroutine
    # scheduler, logging, HTTP/2 framing, interrupt/softirq handling at
    # load) as a multiple of the critical-path processing time.  This is
    # what caps throughput long before latency shows it; Go orchestration
    # services measure 3-5x (pprof on faasd's gateway/provider); Junction's
    # runtime is lean (paper SS5: "compute optimizations ... reduction in
    # context switches").
    offpath_cpu_mult: float = 1.0
    # multiplier on the function body's pure-compute time: 1.0 for native
    # execution, >1 for sandboxes that recompile/interpret the workload
    # (Wasm AOT/JIT) or add per-instruction virtualisation drag.
    work_mult: float = 1.0


KERNEL_RUNTIME = RuntimeCosts(
    name="kernel",
    gateway_us=150.0, provider_us=200.0, watchdog_us=100.0,
    exec_syscall_overhead_us=58.0,
    exec_hiccup_p=0.025, exec_hiccup_lo_ms=0.8, exec_hiccup_hi_ms=2.8,
    app_jitter_sigma=0.30,
    thrash_coeff=0.9, thrash_cap=6.0,
    offpath_cpu_mult=5.0,
)

JUNCTION_RUNTIME = RuntimeCosts(
    name="junction",
    gateway_us=115.0, provider_us=155.0, watchdog_us=76.0,
    exec_syscall_overhead_us=5.0,
    # bounded preemption by the Junction scheduler still leaves a small
    # tail (core steals, quantum waits) — much shorter than CFS/GC.
    exec_hiccup_p=0.015, exec_hiccup_lo_ms=0.08, exec_hiccup_hi_ms=0.3,
    app_jitter_sigma=0.20,
    thrash_coeff=0.05, thrash_cap=1.15,
    offpath_cpu_mult=1.05,
)

# Paper §5: measured Junction single-threaded instance init.
JUNCTION_INSTANCE_INIT_MS = 3.4
# Junctiond scale-up: one uProc spawn inside an already-running libOS.
JUNCTION_UPROC_SPAWN_MS = 0.2
# containerd cold start (container create + start, warm image) — literature
# (firecracker/containerd studies report 300–700 ms for Linux containers).
CONTAINERD_COLDSTART_MS = 450.0
# containerd control-plane state query (the thing the provider cache
# removes from the critical path; paper §4 notes it can exceed the
# function execution time itself).
CONTAINERD_QUERY_MS = 1.8
JUNCTIOND_QUERY_MS = 0.15

# The benchmark function: AES-128-CTR over a 600-byte input (vSwarm),
# pure compute time on one 2.2 GHz Xeon core (~0.5 cycles/byte with AES-NI
# would be ~0.14 µs; vSwarm's Go implementation without AES-NI batching,
# including marshalling, measures ~tens of µs).  We use the measured-ish
# vSwarm Go figure.  It is the paper's host figure; a deployment that runs
# the function on the card measures its own ``work_us`` instead.
AES_600B_WORK_US = 95.0
