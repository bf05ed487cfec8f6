"""Controller-side autoscaling (paper §2.1: "outside of the critical path,
the controller performs autoscaling for both the pool and the function
instances").

The controller samples each function's load signal on a control period and
scales the replica count (uProcs inside a Junction instance, or containers)
within policy bounds.  Two pluggable :class:`ScalePolicy` implementations:

* :class:`QueueDepthPolicy` — the classic queue-depth controller: double
  when in-flight exceeds the per-replica target, halve below the
  hysteresis band, on a fixed control period.
* :class:`LeadTimePolicy` — backend-aware: both the control period and the
  scale-up headroom derive from the backend's
  :class:`~repro_torch.core.backends.ColdStartModel`.  A backend that adds a
  replica in 0.2 ms (junctiond uProc spawn) can afford a tight control
  loop and just-in-time capacity; one that takes 270 ms (containerd task
  start) must sample slowly and over-provision for the arrivals that land
  during its scale-up lead time.  This is the asymmetry the paper's
  cold-start section is about, turned into control-plane behaviour.

Replica truth always comes from the backend lifecycle (``lookup``), never
from a shadow dict — an externally removed function simply drops out of
the control loop (no ghost scale events), and a redeploy re-enters it with
the backend's real replica count.

Every decision is recorded as a structured :class:`ScaleEvent` carrying
the request→decision→ready timestamps, so experiments can measure
scale-up *reaction time* (demand exceeding capacity until new capacity is
ready) — the production-scale metric FaaSNet (arXiv:2105.11229) gates on.

The port's copy of the JAX package's ``core/autoscaler.py``.
"""
from __future__ import annotations

import abc
import dataclasses
import math
from typing import Dict, List, Optional

from repro_torch.core.backends import ColdStartModel, UnknownFunctionError
from repro_torch.core.faas import FaasdRuntime
from repro_torch.core.simulator import Simulator


# ---------------------------------------------------------------------------
# Policies.


@dataclasses.dataclass(frozen=True)
class ScalePolicy(abc.ABC):
    """Pluggable scaling policy: how often to sample, and what replica
    count to want given the load signal.

    A frozen dataclass base: the shared bounds below are the contract
    the :class:`Autoscaler` relies on; implementations add their own
    knobs and set a class-level ``kind``.
    """

    min_replicas: int = 1
    max_replicas: int = 16
    target_inflight_per_replica: float = 4.0
    scale_down_hysteresis: float = 0.5   # scale down below target*this

    kind = ""

    @abc.abstractmethod
    def control_period(self, coldstart: ColdStartModel) -> float:
        """Seconds between controller samples for this backend."""

    @abc.abstractmethod
    def desired(self, *, inflight: float, replicas: int,
                arrival_rate_rps: float,
                coldstart: ColdStartModel) -> int:
        """Replica count to converge to, already clamped to the bounds."""

    # -- shared helpers ---------------------------------------------------
    def clamp(self, want: int) -> int:
        return max(self.min_replicas, min(self.max_replicas, int(want)))

    def overloaded(self, inflight: float, replicas: int) -> bool:
        return inflight > self.target_inflight_per_replica * max(replicas, 0)

    def underloaded(self, inflight: float, replicas: int) -> bool:
        return (inflight < self.target_inflight_per_replica * replicas
                * self.scale_down_hysteresis)


@dataclasses.dataclass(frozen=True)
class QueueDepthPolicy(ScalePolicy):
    """Queue-depth + utilisation driven (the pre-refactor behaviour):
    multiplicative increase/decrease on a fixed control period."""

    period_s: float = 0.25

    kind = "queue-depth"

    def control_period(self, coldstart: ColdStartModel) -> float:
        return self.period_s

    def desired(self, *, inflight, replicas, arrival_rate_rps, coldstart):
        cur = max(1, replicas)
        if self.overloaded(inflight, replicas):
            want = cur * 2
        elif self.underloaded(inflight, replicas) and cur > self.min_replicas:
            want = cur // 2
        else:
            want = replicas
        return self.clamp(want)


@dataclasses.dataclass(frozen=True)
class LeadTimePolicy(ScalePolicy):
    """Backend-aware policy: control period and scale-up headroom derive
    from the backend's :class:`ColdStartModel`.

    * period = clamp(``lead_mult`` x the backend's per-replica scale-up
      time, [``period_floor_s``, ``period_ceil_s``]) — a sub-ms backend
      samples every 10 ms; a 270 ms backend samples at the ceiling.
    * on overload, capacity is sized for *now plus the lead time*: the
      replicas needed for the observed in-flight load, plus headroom for
      the arrivals expected to land while the scale-up is in flight
      (``arrival_rate x scale_seconds`` requests).  Fast backends get
      just-in-time capacity; slow ones must over-provision.
    """

    period_floor_s: float = 0.01
    period_ceil_s: float = 0.25
    lead_mult: float = 2.0

    kind = "lead-time"

    def control_period(self, coldstart: ColdStartModel) -> float:
        return min(self.period_ceil_s,
                   max(self.period_floor_s,
                       self.lead_mult * coldstart.scale_seconds))

    def desired(self, *, inflight, replicas, arrival_rate_rps, coldstart):
        target = self.target_inflight_per_replica
        need = math.ceil(inflight / target) if inflight > 0 else 0
        if self.overloaded(inflight, replicas):
            lead_arrivals = arrival_rate_rps * coldstart.scale_seconds
            headroom = math.ceil(lead_arrivals / target)
            want = need + headroom
        elif self.underloaded(inflight, replicas) \
                and replicas > self.min_replicas:
            want = max(need, replicas // 2)
        else:
            want = replicas
        return self.clamp(want)


# ---------------------------------------------------------------------------
# Telemetry.


@dataclasses.dataclass
class ScaleEvent:
    """One controller decision, with the full request→decision→ready
    timeline.  ``t_request`` is when demand first exceeded capacity (the
    pressure onset; equals ``t_decision`` for scale-downs), ``t_decision``
    the controller tick that acted, ``t_ready`` when the backend finished
    the scale operation (NaN while still in flight / if aborted)."""

    fn: str
    from_replicas: int
    to_replicas: int
    t_request: float
    t_decision: float
    t_ready: float = math.nan
    aborted: bool = False

    @property
    def up(self) -> bool:
        return self.to_replicas > self.from_replicas

    @property
    def cold_starts(self) -> int:
        """Replicas this event had to create."""
        return max(0, self.to_replicas - self.from_replicas)

    @property
    def ready(self) -> bool:
        return math.isfinite(self.t_ready)

    @property
    def reaction_s(self) -> float:
        """Demand-exceeds-capacity until the new capacity is ready."""
        return self.t_ready - self.t_request


# ---------------------------------------------------------------------------
# The controller.


class Autoscaler:
    """Controller loop scaling every deployed function per its policy.

    Load signal: the autoscaler implements the
    :class:`repro_torch.core.workload.SimObserver` protocol — pass it as the
    ``observer`` of :func:`repro_torch.core.workload.drive` and every admitted
    arrival/completion feeds ``on_arrival``/``on_done``.  The
    controller samples the *peak* in-flight count per control period, so
    bursts shorter than the period still register.  Replica truth comes
    from the backend's ``lookup`` — there is no shadow replica dict.
    """

    def __init__(self, sim: Simulator, runtime: FaasdRuntime,
                 policy: Optional[ScalePolicy] = None):
        self.sim = sim
        self.runtime = runtime
        self.policy = policy or QueueDepthPolicy()
        self.inflight: Dict[str, int] = {}
        self.scale_events: List[ScaleEvent] = []
        self.cold_path_arrivals = 0     # arrivals while a scale-up was in flight
        self.cold_starts = 0            # replicas created by completed scale-ups
        self._peak: Dict[str, int] = {}
        self._pressure_t0: Dict[str, float] = {}
        self._arrivals: Dict[str, int] = {}
        self._window_t0: Dict[str, float] = {}
        self._scaling: Dict[str, ScaleEvent] = {}

    # -- load signal ------------------------------------------------------
    def on_arrival(self, fn: str) -> None:
        load = self.inflight.get(fn, 0) + 1
        self.inflight[fn] = load
        self._peak[fn] = max(self._peak.get(fn, 0), load)
        self._arrivals[fn] = self._arrivals.get(fn, 0) + 1
        ev = self._scaling.get(fn)
        if ev is not None and ev.up:
            self.cold_path_arrivals += 1
        cur = self.replicas(fn)
        if cur is None:
            return
        if self.policy.overloaded(load, cur):
            self._pressure_t0.setdefault(fn, self.sim.now)

    def on_done(self, fn: str) -> None:
        self.inflight[fn] = max(0, self.inflight.get(fn, 0) - 1)

    # -- state ------------------------------------------------------------
    def replicas(self, fn: str) -> Optional[int]:
        """Replica truth from the backend lifecycle (None if undeployed)."""
        rec = self.runtime.manager.lookup(fn)
        return None if rec is None else rec.replicas

    # -- the control loop -------------------------------------------------
    def run(self):
        period = self.policy.control_period(self.runtime.backend.coldstart)

        def loop():
            while True:
                yield self.sim.timeout(period)
                self._tick(period)

        return self.sim.process(loop())

    def _drop_state(self, fn: str) -> None:
        self.inflight.pop(fn, None)
        self._peak.pop(fn, None)
        self._pressure_t0.pop(fn, None)
        self._arrivals.pop(fn, None)
        self._window_t0.pop(fn, None)

    def _tick(self, period: float) -> None:
        now = self.sim.now
        for fn in list(self.runtime.functions):
            cur = self.replicas(fn)
            if cur is None:
                # externally removed: no ghost scale events, no stale state
                self._drop_state(fn)
                continue
            if fn in self._scaling:
                # previous op still converging: keep accumulating the
                # peak/rate signal, decide once it lands
                continue
            window = now - self._window_t0.get(fn, now - period)
            self._window_t0[fn] = now
            rate = self._arrivals.pop(fn, 0) / max(window, 1e-9)
            peak = self._peak.pop(fn, 0)
            load = max(self.inflight.get(fn, 0), peak)
            if self.policy.overloaded(load, cur):
                self._pressure_t0.setdefault(fn, now)
            else:
                # pressure subsided without a scale-up (e.g. clamped at
                # max_replicas, or the burst drained): clear the onset so
                # a later scale-up doesn't inherit it and report an
                # inflated reaction time
                self._pressure_t0.pop(fn, None)
            want = self.policy.desired(
                inflight=load, replicas=cur, arrival_rate_rps=rate,
                coldstart=self.runtime.backend.coldstart)
            if want != cur:
                self._issue(fn, cur, want)

    def _issue(self, fn: str, cur: int, want: int) -> None:
        now = self.sim.now
        ev = ScaleEvent(
            fn=fn, from_replicas=cur, to_replicas=want,
            t_request=self._pressure_t0.get(fn, now) if want > cur else now,
            t_decision=now)
        self.scale_events.append(ev)
        self._scaling[fn] = ev

        def do_scale():
            # off the critical path: its own process, warm traffic
            # never waits on it
            try:
                yield from self.runtime.manager.scale(fn, want)
                ev.t_ready = self.sim.now
                self.cold_starts += ev.cold_starts
            except UnknownFunctionError:
                ev.aborted = True           # raced an external remove
            finally:
                self._scaling.pop(fn, None)
                if ev.up:
                    self._pressure_t0.pop(fn, None)   # pressure served

        self.sim.process(do_scale())

    # -- telemetry --------------------------------------------------------
    def telemetry(self) -> Dict[str, object]:
        """Plain-JSON summary of the run's scale events (the artifact's
        ``autoscaler`` block is pooled from these)."""
        done = [e for e in self.scale_events if e.ready and not e.aborted]
        ups = [e for e in done if e.up]
        return {
            "policy": self.policy.kind,
            "n_scale_events": len(self.scale_events),
            "n_up": sum(1 for e in self.scale_events if e.up),
            "n_down": sum(1 for e in self.scale_events if not e.up),
            "n_aborted": sum(1 for e in self.scale_events if e.aborted),
            "cold_starts": self.cold_starts,
            "cold_path_arrivals": self.cold_path_arrivals,
            "reactions_ms": [round(e.reaction_s * 1e3, 4) for e in ups],
            "timeline": [[round(e.t_ready, 6), e.fn, e.to_replicas]
                         for e in sorted(done, key=lambda e: e.t_ready)],
        }
