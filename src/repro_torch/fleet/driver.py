"""Fleet driver: the event-heap open loop over a Cluster.

``drive(cluster, load)`` lands here (dispatched by
:func:`repro_torch.core.workload.drive`).  One shared arrival stream is
sampled from the cluster simulator's rng, each arrival is routed to a
worker by the gateway at admit time, and the invocation then runs the
same hop-compressed station machine as the single-runtime event engine
— against the *routed worker's* core pool, records, and net stack — so
per-worker contention, thrash, and autoscaler signals stay faithful.

Requests admitted into an uncontended worker pool take the fused fast
path (see ``repro_torch.core.workload.FUSED_FAST_PATH``): one precomputed
completion event plus a lazy off-path core release, instead of the
~4-event station walk.  Contended admits fall back to the per-station
machine through ``CorePool.acquire_fast``.

Cost-table pre-sampling is global: same-backend workers share identical
``InvocationPlan``\\ s, so the per-request hold/gap/off-path matrices are
drawn once per function (one vectorized batch) regardless of fleet
size.  Everything runs on the cluster's one clock and heap, so a
same-seed fleet run is byte-identical.

The port's copy of the JAX package's ``fleet/driver.py``.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional

import numpy as np

import repro_torch.core.workload as _workload
from repro_torch.core.faas import InvocationPlan, InvocationRecord
from repro_torch.core.simulator import EventLoop
from repro_torch.core.workload import (LatencySummary, LoadSpec, NullObserver,
                                       SimObserver, _chain_result, _expand_chains,
                                       _fused_arrays, _sample_chain_matrices)
from repro_torch.fleet.cluster import Cluster


def _apportion(total: int, counts: List[int]) -> List[int]:
    """Largest-remainder apportionment of ``total`` integer units over
    buckets proportional to ``counts`` (ties broken by lower index, so
    the split is deterministic)."""
    weight = sum(counts)
    if weight <= 0 or total <= 0:
        return [0] * len(counts)
    quotas = [total * c / weight for c in counts]
    shares = [int(q) for q in quotas]
    left = total - sum(shares)
    if left > 0:
        order = sorted(range(len(counts)),
                       key=lambda j: (shares[j] - quotas[j], j))
        for j in order[:left]:
            shares[j] += 1
    return shares


def drive_cluster(cluster: Cluster, load: LoadSpec,
                  obs: SimObserver) -> Dict[str, object]:
    sim = cluster.sim
    fn_names = load.functions
    n_fn = len(fn_names)
    duration_s = load.duration_s
    warmup_s = load.effective_warmup_s
    drain_s = load.drain_s
    max_out = load.max_outstanding
    t0 = sim.now
    rel = load.arrivals.times(sim.rng, duration_s)
    n = len(rel)
    if n_fn > 1 or load.chains is not None:
        # chained runs always draw picks so the trigger-draw stream
        # that follows stays aligned with the single-runtime engines'
        picks = sim.rng.choice(n_fn, size=n, p=load.normalized_weights())
    else:
        picks = np.zeros(n, dtype=np.intp)
    table = _expand_chains(load, picks, sim.rng,
                           cluster.workers[0].runtime.backend_name)

    AT = t0 + rel
    SC = None
    if table is None:
        N = n
        H = np.empty((n, 3))        # station CPU holds
        G = np.empty((n, 2))        # inter-station latency gaps
        OFF = np.empty(n)           # merged off-path CPU job
        EX = np.empty(n)            # exec-span approximation for records
        stack_cpu = [0.0] * n_fn
        hic_of_fn = [0] * n_fn
        for f, nm in enumerate(fn_names):
            mask = picks == f
            m = int(mask.sum())
            if m == 0:
                continue
            plan = cluster.reference_runtime(nm).invocation_plan(nm)
            h, g, off, ex, n_hic = plan.sample(sim.rng, m)
            H[mask] = h
            G[mask] = g
            OFF[mask] = off
            EX[mask] = ex
            stack_cpu[f] = plan.stack_cpu_s
            # hiccups are sampled per function batch, before routing is
            # known; they are apportioned across the routed workers
            # after the run (see below)
            hic_of_fn[f] = n_hic
    else:
        fn_names = table.fn_names
        n_fn = len(fn_names)
        picks = np.asarray(table.fidx, dtype=np.intp)
        N = int(picks.size)
        H, G, OFF, EX, SC, hic_of_fn = _sample_chain_matrices(
            cluster.reference_runtime, table, sim.rng)

    # flat structure-of-arrays buffers (station holds indexed 3*i+k,
    # gaps 2*i+k) plus the precomputed fused timelines
    H3 = H.ravel().tolist()
    G2 = G.ravel().tolist()
    OFFL = OFF.tolist()
    picksL = picks.tolist()
    if table is None:
        ATL = AT.tolist()
        rootATL = ATL
        ENDL, OFFENDL, CPUL, EXSL, EXEL = _fused_arrays(AT, H, G, OFF, EX)
        ex_start = list(EXSL)       # station machine overwrites its rows
    else:
        # a hop's arrival time is only known when its parent completes:
        # keep the fused timeline relative; _enter stamps the absolutes
        rootATL = AT.tolist()
        ATL = [0.0] * N
        SPANL = (H.sum(axis=1) + G.sum(axis=1)).tolist()
        OFFRELL = (H[:, 0] + OFF).tolist()
        H0G0L = (H[:, 0] + G[:, 0]).tolist()
        ENDL = [0.0] * N
        OFFENDL = [0.0] * N
        ex_start = [0.0] * N
    done_t = [0.0] * N              # completion time; 0.0 = not completed
    wid_of = [-1] * N               # routed worker per request
    fused = bytearray(N)            # fused admits; accounted post-loop

    workers = cluster.workers
    n_workers = len(workers)
    pools = [w.runtime.cores for w in workers]
    route = cluster.gateway.route
    heap = sim._heap
    push = heapq.heappush
    hpush = heapq.heappush
    hpop = heapq.heappop
    counter = sim._counter
    st_weight = InvocationPlan.STATION_BACKLOG_WEIGHT
    off_weight = InvocationPlan.OFFPATH_BACKLOG_WEIGHT
    observed = not isinstance(obs, NullObserver)
    autoscaled = any(w.autoscaler is not None for w in workers)
    fuse = _workload.FUSED_FAST_PATH
    check = _workload.SIM_CHECK
    t_warm = t0 + warmup_s
    outstanding = 0
    admitted = 0
    hop_rejected = 0
    rejected0 = cluster.rejected
    CHILD = table.children if table is not None else None
    # admits per (function, worker): drives the deferred netstack
    # accounting and the hiccup apportionment
    fw_count = [0] * (n_fn * n_workers)

    def _grant(start, i, k):
        pool = pools[wid_of[i]]
        eff = H3[3 * i + k] * pool.thrash()
        push(heap, (start + eff, next(counter), _complete, (i, k, eff, start)))

    def _off_grant(start, wid, off):
        pool = pools[wid]
        eff = off * pool.thrash()
        push(heap, (start + eff, next(counter), _off_done, (wid, eff)))

    def _off_done(wid, eff):
        pools[wid].release_fast(eff)

    def _fused_done(i):
        # one event for the whole fused request: release the routed
        # worker's on-path core and finish (records, latency rows and
        # busy_time/served accounting are materialised after the loop)
        nonlocal outstanding
        wid = wid_of[i]
        pool = pools[wid]
        pool.busy -= 1
        if pool._waiters:
            pool._grant_next()
        outstanding -= 1
        w = workers[wid]
        w.outstanding -= 1
        end = ENDL[i]
        done_t[i] = end
        if autoscaled and w.autoscaler is not None:
            w.autoscaler.on_done(fn_names[picksL[i]])
        if observed:
            obs.on_done(fn_names[picksL[i]])
        if CHILD is not None:
            for c in CHILD[i]:
                _enter(c, end)

    def _complete(i, k, eff, start):
        nonlocal outstanding
        wid = wid_of[i]
        pool = pools[wid]
        pool.release_fast(eff)
        now = start + eff
        if k == 2:
            outstanding -= 1
            w = workers[wid]
            w.outstanding -= 1
            done_t[i] = now
            if autoscaled and w.autoscaler is not None:
                w.autoscaler.on_done(fn_names[picksL[i]])
            if observed:
                obs.on_done(fn_names[picksL[i]])
            if CHILD is not None:
                for c in CHILD[i]:
                    _enter(c, now)
            return
        if k == 0:
            off = OFFL[i]
            if off > 0.0:
                pool.acquire_fast(now, _off_grant, (wid, off),
                                  weight=off_weight)
        else:
            ex_start[i] = start
        pool.acquire_fast(now + G2[2 * i + k], _grant, (i, k + 1),
                          weight=st_weight)

    def _admit(i, t):
        nonlocal outstanding, admitted
        f = picksL[i]
        if outstanding >= max_out:
            cluster.rejected += 1
            return
        w = route(fn_names[f])
        if w is None:
            cluster.rejected += 1
            return
        wid = w.wid
        wid_of[i] = wid
        outstanding += 1
        w.outstanding += 1
        w.admitted += 1
        fw_count[f * n_workers + wid] += 1
        if t >= t_warm:
            admitted += 1
        if autoscaled and w.autoscaler is not None:
            w.autoscaler.on_arrival(fn_names[f])
        if observed:
            obs.on_arrival(fn_names[f])
        pool = pools[wid]
        off_pend = pool._off_pend
        while off_pend and off_pend[0] <= t:    # expired lazy releases
            hpop(off_pend)
            pool.busy -= 1
        if fuse and not pool._waiters:
            b = pool.busy
            off = OFFL[i]
            if off > 0.0:
                if b + 2 < pool.n_cores:
                    if check:
                        _workload._fused_admit_check(pool, t, ENDL[i],
                                                     OFFENDL[i])
                    pool.busy = b + 2
                    fused[i] = 1
                    push(heap, (ENDL[i], next(counter), _fused_done, (i,)))
                    hpush(off_pend, OFFENDL[i])
                    return
            elif b + 1 < pool.n_cores:
                if check:
                    _workload._fused_admit_check(pool, t, ENDL[i])
                pool.busy = b + 1
                fused[i] = 1
                push(heap, (ENDL[i], next(counter), _fused_done, (i,)))
                return
        pool.acquire_fast(t, _grant, (i, 0), weight=st_weight)

    if table is not None:
        DEPTHL = table.depth
        SPANL_ = SPANL
        OFFRELL_ = OFFRELL
        H0G0L_ = H0G0L

        def _enter(i, t):
            # a root arrival or a spawned chain hop: stamp its absolute
            # fused timeline, then route through the gateway as usual
            nonlocal hop_rejected
            ATL[i] = t
            ENDL[i] = t + SPANL_[i]
            OFFENDL[i] = t + OFFRELL_[i]
            ex_start[i] = t + H0G0L_[i]
            r0 = cluster.rejected
            _admit(i, t)
            if cluster.rejected > r0 and DEPTHL[i]:
                hop_rejected += 1

        EventLoop(sim).run(t0 + duration_s + drain_s, rootATL, _enter)
    else:
        _enter = None
        EventLoop(sim).run(t0 + duration_s + drain_s, ATL, _admit)

    # -- deferred per-request accounting --------------------------------
    dt = np.asarray(done_t)
    wids = np.asarray(wid_of)
    fmask = np.frombuffer(fused, dtype=np.uint8).astype(bool) & (dt > 0.0)
    CPU = H.sum(axis=1) + OFF
    exs = np.asarray(ex_start)
    ex_end = exs + EX
    if table is not None:
        AT = np.asarray(ATL)        # hops got their times at spawn
    comp = dt > 0.0
    warm = comp & (AT >= t_warm)
    lat_ms = (dt - AT) * 1e3
    for w in workers:
        wid = w.wid
        rt = w.runtime
        adm = sum(fw_count[f * n_workers + wid] for f in range(n_fn))
        rt.cache_hits += adm        # warm cached resolve per request
        rt.stack.messages += 4 * adm
        wmask = wids == wid
        if SC is None:
            rt.stack.cpu_spent += sum(
                stack_cpu[f] * fw_count[f * n_workers + wid]
                for f in range(n_fn))
        else:
            # chained runs: per-row netstack CPU (payload scales vary
            # within a function), booked on the routed worker
            rt.stack.cpu_spent += float(SC[wmask].sum())
        wf = fmask & wmask
        pool = pools[wid]
        pool.busy_time += float(CPU[wf].sum())
        pool.served += int(3 * wf.sum() + np.count_nonzero(wf & (OFF > 0.0)))
        # records in completion order, on the routed worker's runtime
        widx = np.flatnonzero(comp & wmask)
        widx = widx[np.argsort(dt[widx], kind="stable")]
        append = rt.records.append
        for i in widx.tolist():
            append(InvocationRecord(fn_names[picksL[i]], ATL[i],
                                    float(exs[i]), float(ex_end[i]),
                                    done_t[i]))

    # hiccups: apportion each function's sampled count across the
    # workers its requests were actually routed to (largest remainder);
    # a function whose batch never routed keeps the pre-PR behaviour of
    # booking on its reference worker
    for f, nm in enumerate(fn_names):
        n_hic = hic_of_fn[f]
        if n_hic <= 0:
            continue
        counts = fw_count[f * n_workers:(f + 1) * n_workers]
        if sum(counts) == 0:
            cluster.reference_runtime(nm).stack.hiccups += n_hic
            continue
        for wid, share in enumerate(_apportion(n_hic, counts)):
            if share:
                workers[wid].runtime.stack.hiccups += share

    # -- assembly (vectorized; same schema as workload._events_result) --
    lat = lat_ms[warm]
    dmask = warm & (dt <= t0 + duration_s + drain_s)
    n_done = int(np.count_nonzero(dmask))
    summary = LatencySummary.of(lat)
    per_fn: Dict[str, LatencySummary] = {}
    pw = picks[warm]
    for f, name in enumerate(fn_names):
        fn_lat = lat[pw == f]
        if fn_lat.size:
            per_fn[name] = LatencySummary.of(fn_lat)
    if n_done:
        span = max(1e-9, max(float(dt[dmask].max()), t0 + duration_s)
                   - (t0 + warmup_s))
        completion_rps = n_done / span
    else:
        completion_rps = 0.0
    gw = cluster.gateway
    worker_rows = []
    for w in workers:
        wlat = lat_ms[warm & (wids == w.wid)]
        ws: Optional[LatencySummary] = \
            LatencySummary.of(wlat) if wlat.size else None
        worker_rows.append({
            "worker": w.wid,
            "n": int(wlat.size),
            "placements": gw.placements[w.wid],
            "median_ms": round(ws.median_ms, 4) if ws else None,
            "p99_ms": round(ws.p99_ms, 4) if ws else None,
        })
    chain_block = (None if table is None else
                   _chain_result(table, AT, done_t, EX, t_warm,
                                 hop_rejected))
    res = {
        "offered_rps": n / max(duration_s, 1e-9),
        "achieved_rps": n_done / max(1e-9, duration_s - warmup_s),
        "completion_rps": completion_rps,
        "completed_frac": n_done / max(1, admitted),
        "median_ms": summary.median_ms,
        "p99_ms": summary.p99_ms,
        "mean_ms": summary.mean_ms,
        "p999_ms": summary.p999_ms,
        "n": summary.n,
        "rejected": cluster.rejected - rejected0,
        "per_fn": per_fn,
        "latencies_ms": lat.tolist(),
        "fleet": {
            "n_workers": n_workers,
            "placement": gw.policy.kind,
            "distribution": cluster.distribution.kind,
            "workers": worker_rows,
            "expansions": list(gw.expansions),
        },
    }
    if chain_block is not None:
        res["chain"] = chain_block
    return res
