"""Calibrated per-operation cost constants for the two datapaths.

The port's copy of the JAX package's ``core/latency.py``: the tables of the
paper's pair (containerd and junctiond) and of the four modeled backends
from related work (quark, wasm, firecracker, gvisor), with their cold-start
and query constants.  They are the paper's x86 host costs and figures from
the related-work literature: nothing here was measured on a TPU or a GPU.

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

# --- modeled backends from related work -----------------------------------
#
# Quark-style secure container runtime (arXiv:2309.12624): containers run
# on a user-space guest kernel (QKernel) behind a hypervisor boundary
# (QVisor).  Every syscall and every packet crosses the interception
# layer, so the kernel datapath costs grow; cold start pays a guest-kernel
# boot on top of the container create.

QUARK_STACK = StackCosts(
    name="quark",
    send_lat_us=9.0,      # sendmsg forwarded through QVisor + host TCP tx
    wire_us=1.0,
    rx_lat_us=10.0,       # host rx + virtio-style delivery into the guest
    wakeup_us=18.0,       # host interrupt + guest scheduler wakeup
    tx_cpu_us=8.0, rx_cpu_us=9.0, wakeup_cpu_us=4.0,
    per_kb_us=1.0,        # extra copy across the sandbox boundary
    jitter_sigma=0.32,
    hiccup_p=0.012, hiccup_lo_ms=0.7, hiccup_hi_ms=2.4,
)

QUARK_RUNTIME = RuntimeCosts(
    name="quark",
    gateway_us=172.0, provider_us=230.0, watchdog_us=115.0,
    exec_syscall_overhead_us=140.0,   # per-syscall interception tax
    exec_hiccup_p=0.028, exec_hiccup_lo_ms=0.8, exec_hiccup_hi_ms=3.0,
    app_jitter_sigma=0.32,
    thrash_coeff=0.95, thrash_cap=6.0,
    offpath_cpu_mult=5.5,
    work_mult=1.08,                   # guest-kernel virtualisation drag
)

# Wasm-style lightweight sandbox (arXiv:2010.07115, WasmEdge-class): the
# function is a Wasm module instantiated in-process.  Kernel network stack
# (no bypass), but instantiation is sub-ms and OS interactions go through
# a thin WASI shim; the compute itself pays a moderate AOT/JIT overhead.

WASM_RUNTIME = RuntimeCosts(
    name="wasm",
    gateway_us=150.0, provider_us=200.0, watchdog_us=70.0,
    exec_syscall_overhead_us=24.0,    # WASI shim, far fewer OS round-trips
    exec_hiccup_p=0.020, exec_hiccup_lo_ms=0.6, exec_hiccup_hi_ms=2.0,
    app_jitter_sigma=0.28,
    thrash_coeff=0.9, thrash_cap=6.0,
    offpath_cpu_mult=4.2,
    work_mult=1.35,                   # moderate compute overhead vs native
)

# Firecracker-style microVM (NSDI '20): a minimal VMM boots a slim guest
# kernel per function.  The datapath rides virtio-net through TWO stacks
# (guest kernel TCP + host tap forwarding), so warm costs sit just above
# plain containers; the cold path is where the design moves — a full
# microVM boot is ~125 ms, but restoring a pre-warmed snapshot takes
# single-digit ms (the serverless snapshot-restore literature, e.g.
# arXiv:2202.09251 and the unikernel comparisons in arXiv:2403.00515,
# report 3–10 ms restores).

FIRECRACKER_STACK = StackCosts(
    name="firecracker",
    send_lat_us=7.0,      # guest TCP tx + virtio-net + host tap forward
    wire_us=1.0,
    rx_lat_us=8.0,        # host rx + virtio delivery into the guest
    wakeup_us=16.5,       # host interrupt + guest vCPU wakeup
    tx_cpu_us=6.5, rx_cpu_us=7.5, wakeup_cpu_us=3.5,
    per_kb_us=0.8,        # extra copy across the virtio boundary
    jitter_sigma=0.31,
    hiccup_p=0.011, hiccup_lo_ms=0.7, hiccup_hi_ms=2.3,
)

FIRECRACKER_RUNTIME = RuntimeCosts(
    name="firecracker",
    gateway_us=158.0, provider_us=212.0, watchdog_us=104.0,
    exec_syscall_overhead_us=75.0,    # mostly-native guest syscalls + VM exits
    exec_hiccup_p=0.026, exec_hiccup_lo_ms=0.8, exec_hiccup_hi_ms=2.8,
    app_jitter_sigma=0.30,
    thrash_coeff=0.92, thrash_cap=6.0,
    offpath_cpu_mult=5.1,
    work_mult=1.02,                   # near-native compute inside the guest
)

# gVisor-style sandboxed runtime (runsc): the Sentry, a user-space kernel
# written in Go, intercepts every syscall and owns a user-space netstack.
# With the KVM platform the interception is a lightweight VM exit; with
# the ptrace platform every syscall costs two context switches, several
# times slower (gVisor's own platform guide and the published syscall
# microbenchmarks).  Warm costs land between containerd and quark.

GVISOR_KVM_STACK = StackCosts(
    name="gvisor-kvm",
    send_lat_us=8.0,      # Sentry netstack tx + host forward
    wire_us=1.0,
    rx_lat_us=9.0,        # host rx + netstack delivery
    wakeup_us=17.0,       # host interrupt + Sentry goroutine wakeup
    tx_cpu_us=7.0, rx_cpu_us=8.0, wakeup_cpu_us=4.0,
    per_kb_us=0.9,        # copy through the Sentry
    jitter_sigma=0.32,
    hiccup_p=0.012,       # Go GC pauses inside the Sentry
    hiccup_lo_ms=0.7, hiccup_hi_ms=2.4,
)

GVISOR_KVM_RUNTIME = RuntimeCosts(
    name="gvisor-kvm",
    gateway_us=165.0, provider_us=222.0, watchdog_us=110.0,
    exec_syscall_overhead_us=112.0,   # Sentry interception via KVM exits
    exec_hiccup_p=0.027, exec_hiccup_lo_ms=0.8, exec_hiccup_hi_ms=2.9,
    app_jitter_sigma=0.31,
    thrash_coeff=0.93, thrash_cap=6.0,
    offpath_cpu_mult=5.3,
    work_mult=1.05,
)

GVISOR_PTRACE_STACK = StackCosts(
    name="gvisor-ptrace",
    send_lat_us=11.0,     # every netstack hop pays ptrace stops
    wire_us=1.0,
    rx_lat_us=12.0,
    wakeup_us=19.0,
    tx_cpu_us=9.5, rx_cpu_us=10.5, wakeup_cpu_us=4.5,
    per_kb_us=1.1,
    jitter_sigma=0.33,
    hiccup_p=0.013, hiccup_lo_ms=0.7, hiccup_hi_ms=2.5,
)

GVISOR_PTRACE_RUNTIME = RuntimeCosts(
    name="gvisor-ptrace",
    gateway_us=170.0, provider_us=228.0, watchdog_us=112.0,
    exec_syscall_overhead_us=230.0,   # two context switches per syscall
    exec_hiccup_p=0.028, exec_hiccup_lo_ms=0.8, exec_hiccup_hi_ms=3.0,
    app_jitter_sigma=0.33,
    thrash_coeff=0.95, thrash_cap=6.0,
    offpath_cpu_mult=5.6,
    work_mult=1.06,
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
# Quark: container create + guest kernel (QKernel) boot behind QVisor.
QUARK_COLDSTART_MS = 620.0
QUARK_QUERY_MS = 2.1
# Wasm: module instantiation from a compiled image — sub-ms.
WASM_COLDSTART_MS = 0.6
WASM_QUERY_MS = 0.4
# Firecracker: full microVM boot (VMM init + guest kernel + init) vs
# restoring a pre-warmed memory/device snapshot of the booted guest.
# Warming the snapshot is not free: the first boot also pauses the VM
# and serializes guest memory + device state to disk before the cache
# can serve restores.
FIRECRACKER_BOOT_MS = 125.0
FIRECRACKER_SNAPSHOT_SAVE_MS = 60.0
FIRECRACKER_RESTORE_MS = 5.0
FIRECRACKER_QUERY_MS = 1.6
# gVisor: runsc create + Sentry boot — no guest Linux kernel to bring up,
# so it lands just under a containerd cold start (and well under quark's
# guest-kernel boot).
GVISOR_COLDSTART_MS = 400.0
GVISOR_QUERY_MS = 1.9

# The benchmark function: AES-128-CTR over a 600-byte input (vSwarm),
# pure compute time on one 2.2 GHz Xeon core (~0.5 cycles/byte with AES-NI
# would be ~0.14 µs; vSwarm's Go implementation without AES-NI batching,
# including marshalling, measures ~tens of µs).  We use the measured-ish
# vSwarm Go figure.  It is the paper's host figure; a deployment that runs
# the function on the card measures its own ``work_us`` instead.
AES_600B_WORK_US = 95.0
