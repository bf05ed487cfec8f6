"""Deterministic discrete-event engine (SimPy-lite, generator coroutines).

The FaaS runtime (gateway, provider, function instances), both network
stacks, and the Junction scheduler are modelled as processes on this
engine.  Time unit: **seconds** (float); typical granule is microseconds.

Why a DES and not wall-clock threads: the paper's claims are about µs-scale
networking/scheduling behaviour that a CPython process cannot reproduce
natively; a DES makes the *architecture* (hop counts, queue ownership,
polling placement, preemption) explicit and measurable, with calibrated
per-operation costs, and is exactly reproducible for tests.

The port's copy of the JAX package's ``core/simulator.py``: numpy on the
host, the same event order and the same RNG streams, so one seed gives the
same latencies in both packages.  The flat-callback ``EventLoop`` of the
open-loop ``drive`` comes with it (ROADMAP.md, queue 1 item 6d).
"""
from __future__ import annotations

import heapq
import itertools
from collections import deque
from typing import Any, Callable, Generator, List, Optional

import numpy as np


class Event:
    """One-shot event; processes wait on it, success carries a value."""

    __slots__ = ("sim", "triggered", "value", "_waiters", "callbacks")

    def __init__(self, sim: "Simulator"):
        self.sim = sim
        self.triggered = False
        self.value: Any = None
        self._waiters: List["Process"] = []
        self.callbacks: List[Callable[[Any], None]] = []

    def succeed(self, value: Any = None) -> "Event":
        if self.triggered:
            raise RuntimeError("event already triggered")
        self.triggered = True
        self.value = value
        for cb in self.callbacks:
            cb(value)
        waiters, self._waiters = self._waiters, []
        for proc in waiters:
            self.sim._schedule(0.0, proc._resume, value)
        return self

    def _add_waiter(self, proc: "Process") -> None:
        if self.triggered:
            self.sim._schedule(0.0, proc._resume, self.value)
        else:
            self._waiters.append(proc)


class Timeout(Event):
    def __init__(self, sim: "Simulator", delay: float):
        super().__init__(sim)
        sim._schedule(delay, self._fire)

    def _fire(self) -> None:
        if not self.triggered:
            self.succeed()


class Process:
    """A generator coroutine; yields Events (or Timeouts) to wait."""

    __slots__ = ("sim", "gen", "done", "result", "_completion")

    def __init__(self, sim: "Simulator", gen: Generator):
        self.sim = sim
        self.gen = gen
        self.done = False
        self.result: Any = None
        self._completion: Optional[Event] = None
        sim._schedule(0.0, self._resume, None)

    @property
    def completion(self) -> Event:
        if self._completion is None:
            self._completion = Event(self.sim)
            if self.done:
                self._completion.succeed(self.result)
        return self._completion

    def _resume(self, value: Any = None) -> None:
        if self.done:
            return
        try:
            ev = self.gen.send(value)
        except StopIteration as stop:
            self.done = True
            self.result = getattr(stop, "value", None)
            if self._completion is not None and not self._completion.triggered:
                self._completion.succeed(self.result)
            return
        if not isinstance(ev, Event):
            raise TypeError(f"process yielded {type(ev)}; yield an Event/Timeout")
        ev._add_waiter(self)


class Queue:
    """Unbounded FIFO with blocking get (used for NIC queues, run queues)."""

    __slots__ = ("sim", "items", "_getters")

    def __init__(self, sim: "Simulator"):
        self.sim = sim
        self.items: deque = deque()
        self._getters: deque = deque()

    def put(self, item: Any) -> None:
        if self._getters:
            ev = self._getters.popleft()
            ev.succeed(item)
        else:
            self.items.append(item)

    def get(self) -> Event:
        ev = Event(self.sim)
        if self.items:
            ev.succeed(self.items.popleft())
        else:
            self._getters.append(ev)
        return ev

    def __len__(self) -> int:
        return len(self.items)


class Simulator:
    def __init__(self, seed: int = 0):
        self._heap: list = []
        self._counter = itertools.count()
        self.now = 0.0
        self.rng = np.random.default_rng(seed)
        self.stopped = False

    # -- scheduling -----------------------------------------------------
    def _schedule(self, delay: float, fn: Callable, *args) -> None:
        heapq.heappush(self._heap, (self.now + delay, next(self._counter), fn, args))

    def timeout(self, delay: float) -> Timeout:
        return Timeout(self, max(0.0, delay))

    def event(self) -> Event:
        return Event(self)

    def queue(self) -> Queue:
        return Queue(self)

    def process(self, gen: Generator) -> Process:
        return Process(self, gen)

    # -- execution ------------------------------------------------------
    def run(self, until: float = float("inf")) -> None:
        self.stopped = False
        while self._heap and not self.stopped:
            t, _, fn, args = self._heap[0]
            if t > until:
                break
            heapq.heappop(self._heap)
            self.now = t
            fn(*args)
        if until != float("inf") and not self.stopped:
            self.now = max(self.now, until)

    def stop(self) -> None:
        self.stopped = True

    # -- randomness helpers ---------------------------------------------
    def lognormal_us(self, median_us: float, sigma: float) -> float:
        """Lognormal latency in seconds given median in µs."""
        return float(self.rng.lognormal(np.log(median_us), sigma)) * 1e-6

    def exponential(self, mean: float) -> float:
        return float(self.rng.exponential(mean))
