"""Serving engine: prefill and decode steps plus the generation loop.

Counterpart of the JAX package's ``serving/engine.py``, with the same API
and step-time semantics: ``step_times_s[0]`` is the prefill, the rest are
decode steps, and ``mean_decode_step_us`` averages the decode steps only.
Each step is timed on the host clock up to ``torch.cuda.synchronize()``,
where the JAX engine waits with ``block_until_ready``.

Where the JAX engine jits its two steps, this one captures each on the card
as a CUDA graph (``serving.step_graph``) and replays it.  The prefill is
captured at the first prefill of each prompt shape (``prefill_key``: rows,
prompt length, encoder frames and the batch's inputs), as ``jax.jit``
retraces ``_prefill`` for each new shape, and every graph is kept; the
decode step at its first decode of each batch shape, replayed for each new
token with ``pos`` a device scalar as the JAX step's ``jnp.int32(pos)``.
So that the graphs read the same addresses on every call, the engine
allocates the caches once per batch shape (rows, encoder frames:
``T.init_caches``, and an enc-dec model's cross K/V buffers), shared by
every prompt length; the prefill zeroes the recurrent states, prefills the
caches in place and copies its cross K/V into those buffers.  Every graph of
an engine comes from one memory pool, safe under the invariant stated in
``graphs.py``.  The JAX engine's first call of a shape includes its
compile; here each capture (an eager warm-up and the capture itself) is
timed apart, in ``capture_s``, and ``step_times_s`` holds replays only.  A
failed capture raises.  ``prefill="eager"`` and ``decode="eager"`` keep
the previous designs, the steps dispatched op by op (the decode step with a
Python ``pos``), which ``chip_smoke.py`` times beside the replays.

It runs on the card unless the caller passes ``device="cpu"``; there the
attention ops take their plain versions, and the two step functions, the
same that the card captures, run eagerly, since the CPU has no graph.
``params=`` takes a ready tree, for example JAX weights from
``models.convert.params_from_jax``.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.config import ArchConfig
from repro_torch.models import transformer as T
from repro_torch.serving.batcher import ContinuousBatcher
from repro_torch.serving.kvcache import PagedKVManager
from repro_torch.serving.sampling import sample
from repro_torch.serving.step_graph import DecodeGraph, PrefillGraph

STEP_MODES = ("graph", "eager")


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises if it asks for a missing card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' for the plain path")
    return dev


def prefill_key(batch: dict) -> tuple:
    """The prompt shape a prefill of ``batch`` is captured for: (rows,
    prompt length, encoder frames (0 without), the names of its inputs)."""
    x = batch["embeds"] if "embeds" in batch else batch["tokens"]
    frames = batch["enc_embeds"].shape[1] if "enc_embeds" in batch else 0
    return (x.shape[0], x.shape[1], frames, tuple(sorted(batch)))


class ServingEngine:
    def __init__(self, cfg: ArchConfig, *, batch_slots: int = 4,
                 max_seq_len: int = 256, seed: int = 0, device="cuda",
                 params: Optional[dict] = None, prefill: str = "graph",
                 decode: str = "graph"):
        for step, mode in (("prefill", prefill), ("decode", decode)):
            if mode not in STEP_MODES:
                raise ValueError(f"{step} {mode!r}: choose one of {STEP_MODES}")
        self.cfg = cfg
        self.max_seq_len = max_seq_len
        self.device = resolve_device(device)
        self.prefill_mode, self.decode_mode = prefill, decode
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = T.init_params(cfg, gen, self.device)
        self.params = params
        self.kv = PagedKVManager(cfg, batch_slots, max_seq_len)
        self.batcher = ContinuousBatcher(self.kv, batch_slots)
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.step_times_s: List[float] = []
        self.capture_s: List[float] = []             # one entry a capture, prefill or decode
        # by batch shape (rows, encoder frames): the static caches, the decode graph
        self._states: Dict[Tuple[int, int], dict] = {}
        self.decode_graphs: Dict[Tuple[int, int], DecodeGraph] = {}
        self.prefill_graphs: Dict[tuple, PrefillGraph] = {}   # by ``prefill_key``
        self._pool: Optional[tuple] = None           # the memory pool of every graph
        self._key: Optional[Tuple[int, int]] = None  # the last prefill's batch shape

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _graph_pool(self) -> tuple:
        """The one memory pool of this engine's graphs (``graphs.py``)."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    @torch.inference_mode()
    def prefill(self, batch: dict) -> torch.Tensor:
        """The prefill step on ``batch`` (``T.prefill``'s) into the static
        caches of its batch shape, allocated at their first use; returns the
        last token's logits.  The decode steps after it read these caches.
        On the card a replay of the graph captured at this prompt shape's
        first prefill (the logits are then the graph's buffer, valid until
        the next step)."""
        return self._prefiller(batch)(batch)

    def _prefiller(self, batch: dict):
        """The prefill of ``batch``'s prompt shape as a function of the
        batch: the graph's replay on the card (captured here at its first
        use), else ``prefill_step`` called eagerly (on the CPU, and in the
        ``"eager"`` design)."""
        step = self.prefill_step(batch)
        if self.device.type == "cpu" or self.prefill_mode == "eager":
            return step
        key = prefill_key(batch)
        graph = self.prefill_graphs.get(key)
        if graph is None:
            graph = self.prefill_graphs[key] = PrefillGraph(step, batch, self.device,
                                                            self._graph_pool())
            self.capture_s.append(graph.capture_s)
        return graph.replay

    def prefill_step(self, batch: dict):
        """The prefill the card captures for ``batch``'s prompt shape, as a
        function of a batch of that shape: it zeroes the recurrent states
        (the prefill's initial state), prefills the static caches of the
        batch shape (rows, encoder frames; allocated here at their first
        use) in place, copies an enc-dec prefill's cross K/V and valid mask
        into the buffers the engine keeps, and returns the last token's
        logits.  The decode steps read that batch shape's caches from here
        on."""
        x = batch["embeds"] if "embeds" in batch else batch["tokens"]
        key = (x.shape[0], batch["enc_embeds"].shape[1] if "enc_embeds" in batch else 0)
        state = self._states.get(key)
        if state is None:
            state = self._states[key] = {
                "layers": T.init_caches(self.params, self.cfg, key[0], self.max_seq_len)}
            if key[1]:
                state.update(T.init_cross_caches(self.params, self.cfg, *key))
        self._key = key

        def step(b):
            for t in T.recurrent_states(self.cfg, state["layers"]):
                t.zero_()
            logits, out = T.prefill(self.params, self.cfg, b, seq_len=self.max_seq_len,
                                    caches=state["layers"])
            if "cross_kv" in out:
                for (k, v), (nk, nv) in zip(state["cross_kv"], out["cross_kv"]):
                    k.copy_(nk)
                    v.copy_(nv)
                state["cross_valid"].copy_(out["cross_valid"])
            return logits

        return step

    @torch.inference_mode()
    def decode_step(self, tokens: torch.Tensor, pos: int) -> torch.Tensor:
        """The decode step of the last prefill's batch: ``tokens`` (B, 1)
        at ``pos`` -> logits (B, 1, V).  On the card a replay of the graph
        captured at this batch shape's first decode (the logits are then the
        graph's buffer, valid until the next step)."""
        return self._decoder(tokens, pos)(tokens, pos)

    def _decoder(self, tokens: torch.Tensor, pos: int):
        """The decode step of the last prefill's batch as a function of
        (tokens, pos): the graph's replay on the card (captured here at its
        first use), else the step called eagerly, with ``pos`` a device
        scalar on the CPU and a Python int in the ``"eager"`` design."""
        state = self._states[self._key]

        def step(tok, p):
            return T.decode_step(self.params, self.cfg, tok, p, state)[0]

        if self.device.type == "cpu":
            return lambda tok, p: step(tok, torch.tensor(p, device=self.device))
        if self.decode_mode == "eager":
            return step
        graph = self.decode_graphs.get(self._key)
        if graph is None:
            graph = self.decode_graphs[self._key] = DecodeGraph(
                step, tokens, pos, T.recurrent_states(self.cfg, state["layers"]),
                self._graph_pool())
            self.capture_s.append(graph.capture_s)
        return graph.replay

    @torch.inference_mode()
    def capture(self, batch: dict, tokens: torch.Tensor, pos: int) -> None:
        """Capture, without replaying them, the prefill graph of ``batch``'s
        prompt shape and the decode graph of its batch shape (a step of
        ``tokens`` (B, 1) at ``pos``, on the caches the prefill's warm-up
        filled), as the first prefill and decode step of that shape would:
        the ahead-of-time counterpart of compiling a jitted step before its
        first call.  A step in the ``"eager"`` design, and any step on the
        CPU, has nothing to capture."""
        if self.device.type == "cpu":
            return
        if self.prefill_mode == "graph":
            self._prefiller(batch)
        else:
            self.prefill_step(batch)(batch)
        if self.decode_mode == "graph":
            self._decoder(tokens, pos)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def generate(self, prompts: List[List[int]], max_new_tokens: int = 8,
                 temperature: float = 0.0, inputs: Optional[dict] = None
                 ) -> List[List[int]]:
        """Batched greedy/temperature generation (all prompts same length;
        the batcher handles slot lifecycle).  ``inputs`` adds the batch's
        other entries to the prefill: an enc-dec model's ``"enc_embeds"``
        (B, frames, width) and ``"enc_mask"``, or a frontend's ``"embeds"``
        (B, S, width), which take the place of the prompts' tokens (the
        prompts then give only their lengths)."""
        batch = dict(inputs or {})
        plen = len(prompts[0])
        if any(len(p) != plen for p in prompts):
            raise ValueError("batch requires equal prompt lengths")
        if "embeds" in batch and tuple(batch["embeds"].shape[:2]) != (len(prompts), plen):
            raise ValueError("embeds must be (len(prompts), prompt length, width)")
        reqs = [self.batcher.submit(p, max_new_tokens) for p in prompts]
        self.batcher.admit_ready()
        if "embeds" not in batch:
            batch["tokens"] = torch.tensor(prompts, dtype=torch.long, device=self.device)
        prefill = self._prefiller(batch)                # a capture stays untimed
        t0 = time.perf_counter()
        logits = prefill(batch)
        self._sync()
        self.step_times_s.append(time.perf_counter() - t0)
        pos = plen
        next_tok = sample(logits, self._gen, temperature)
        toks = next_tok.tolist()
        for slot, r in list(self.batcher.running.items()):
            self.batcher.record_token(slot, toks[slot])
        while any(not r.done for r in reqs) and pos < self.max_seq_len - 1:
            decode = self._decoder(next_tok[:, None], pos)   # a capture stays untimed
            t0 = time.perf_counter()
            logits = decode(next_tok[:, None], pos)
            self._sync()
            self.step_times_s.append(time.perf_counter() - t0)
            next_tok = sample(logits, self._gen, temperature)
            toks = next_tok.tolist()
            pos += 1
            for slot in list(self.batcher.running):
                self.batcher.record_token(slot, toks[slot])
            if not self.batcher.running:
                break
        return [r.generated for r in reqs]

    # ------------------------------------------------------------------
    def mean_decode_step_us(self) -> float:
        if len(self.step_times_s) <= 1:
            return float("nan")
        return 1e6 * sum(self.step_times_s[1:]) / len(self.step_times_s[1:])
