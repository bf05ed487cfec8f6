"""What a serving or training run of one configuration holds on one card,
reckoned before it allocates: the batch is the largest of ``BATCHES`` that
fits ``CARD_BYTES``, and the depth is cut only where the weights force it.

    PYTHONPATH=src python -m repro_torch.launch.fit

prints the plan of ``PLAN`` (the assigned input shapes on one H100, run by
``chip_smoke.py`` phase 13): each pair's batch, depth and bytes, or why it
does not fit.

The bytes are counted by running the step itself on the meta device (shapes
and dtypes, no storage) under a dispatch mode that holds every storage from
the op that made it until its last tensor dies: the step's high-water mark
of live bytes, tensor by tensor, as the caching allocator sees them
requested.  The kernels are stood in for by what their wrappers allocate:
their outputs (the scans are ``kernels.trace_ops``' operators, as in the dry
run); under autograd by functions that save what ``kernels.ops``' autograd
functions save and return gradients of their inputs' shapes; AdamW updates
in place.  A reckoning (``Reckoning``) holds:

- ``weights``: the parameter tree (``transformer.init_params``);
- ``state``: serving, the engine's static caches (a windowed model's KV
  cache is a ring of min(max_seq_len, window) slots, ``init_caches``);
  training, AdamW's fp32 moments;
- ``step``: the peak of one step's live bytes above weights and state: a
  prefill of B x S tokens (a decode step's is far smaller), or a training
  step (forward under remat, loss, the gradients, update);
- ``pools``: how many copies of ``step`` the run holds at once, each grown
  by ``ALLOCATOR_SLACK``, the caching allocator's rounding and the blocks it
  cannot reuse.  Serving in turns, the graphs replayed beside the eager
  steps (``chip_smoke.py`` phases 5-5j), holds two: the graphs' memory pool
  and what the eager prefill leaves in the allocator's cache.  Serving once
  (the eager design first, the cache emptied, then the graphs) and training
  (the captured step and the eager one, each with its own weights, freed
  between) hold one.

``total = weights + state + pools * ALLOCATOR_SLACK[kind] * step + RESERVE``,
held to ``CARD_BYTES``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import weakref
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.config import ArchConfig, get_arch
from repro_torch.launch.dryrun import serving_variant, with_layers
from repro_torch.models import transformer as T
from repro_torch.models.layers import tree_leaves, tree_map

#: the device memory of an NVIDIA H100 80GB HBM3 as torch reports it
#: (``total_memory``: 79.2 GiB)
CARD_BYTES = 85.0e9
#: batches tried, largest first
BATCHES = (8, 4, 2, 1)
#: a copy of a step's peak as the caching allocator holds it, over the peak
#: the trace counts (rounding, and blocks freed in one size that a request
#: of another cannot take), by kind: measured on the H100 (chip_smoke.py
#: phase 13): a 32768-token prefill's graph pool held 1.65 x its traced
#: peak and the eager prefill beside it 1.5 x; a training step 1.21 x
ALLOCATOR_SLACK = {"serve": 1.7, "train": 1.3}
#: bytes held beside the model: the CUDA context (0.75 GiB beside torch's
#: allocator on the H100), cuBLAS's workspaces, the logits a run keeps
RESERVE = 1.5e9
#: the new tokens a served request generates after its prompt
NEW_TOKENS = 32

#: the assigned shapes the card runs (``config/shapes.py``), by arch:
#: "serve_32k" a prefill_32k prompt then decode_32k steps through one
#: engine; "long_500k" a 524288-token prompt then decode steps, at batch 1;
#: "train_4k" training steps of 4096 tokens
PLAN: Dict[str, Tuple[str, ...]] = {
    "serve_32k": ("qwen3-1.7b", "phi4-mini-3.8b", "h2o-danube-3-4b", "rwkv6-1.6b",
                  "mixtral-8x7b", "jamba-v0.1-52b"),
    "long_500k": ("rwkv6-1.6b", "qwen3-1.7b", "h2o-danube-3-4b", "mixtral-8x7b",
                  "jamba-v0.1-52b"),
    "train_4k": ("qwen3-1.7b", "rwkv6-1.6b"),
}
#: sequence length of each of ``PLAN``'s shapes
SEQ_LEN = {"serve_32k": 32768, "long_500k": 524288, "train_4k": 4096}


@dataclasses.dataclass(frozen=True)
class Reckoning:
    """The bytes of one run of ``arch`` (``kind`` "serve" or "train") at
    ``batch`` x ``seq_len`` with ``layers`` layers; see the module's
    docstring."""
    arch: str
    kind: str
    batch: int
    seq_len: int
    layers: int
    weights: int
    state: int
    step: int
    pools: int

    @property
    def slack(self) -> float:
        return ALLOCATOR_SLACK[self.kind]

    @property
    def total(self) -> float:
        return self.weights + self.state + self.pools * self.slack * self.step + RESERVE

    def fits(self, budget: float = CARD_BYTES) -> bool:
        return self.total <= budget

    def line(self) -> str:
        what = "caches" if self.kind == "serve" else "moments"
        return (f"{self.arch} {self.kind} B {self.batch} x {self.seq_len}, {self.layers} layers: "
                f"weights {self.weights / 1e9:.2f} GB, {what} {self.state / 1e9:.2f} GB, a "
                f"step's peak {self.step / 1e9:.2f} GB x {self.pools} x {self.slack}, "
                f"reserve {RESERVE / 1e9:.1f} GB: {self.total / 1e9:.2f} GB "
                + ("fits" if self.fits() else "does not fit") + f" {CARD_BYTES / 1e9:.0f} GB")


# ---------------------------------------------------------------------------
# live bytes on the meta device


class LiveBytes(TorchDispatchMode):
    """Every storage an op makes, held from that op until its last tensor
    dies (``live``), and their high-water mark (``peak``); ``hold`` counts
    tensors made before the mode (weights, caches)."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._held = WeakIdKeyDictionary()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._hold(t.untyped_storage())
        return out

    def hold(self, tree) -> None:
        for t in pytree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self._hold(t.untyped_storage())

    def _hold(self, storage) -> None:
        if storage in self._held:
            return
        n = storage.nbytes()
        self._held[storage] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._release, n)

    def _release(self, n: int) -> None:
        self.live -= n


class _Saved(torch.autograd.Function):
    """A kernel's output of ``shape`` under autograd, saving its inputs and
    the output as ``ops``' autograd functions do; the backward returns
    gradients of the inputs' shapes (what the backward kernels allocate)."""

    @staticmethod
    def forward(ctx, shape, *inputs):
        out = inputs[0].new_empty(shape)
        ctx.save_for_backward(*inputs, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        *inputs, _ = ctx.saved_tensors
        return (None, *(torch.empty_like(t) for t in inputs))


def _flash(q, k, v, *, causal=True, window=None, key_valid=None):
    return _Saved.apply(q.shape, q, k, v)


def _decode(q, k, v, valid):
    return q.new_empty(q.shape)


def _gmm(x, w):
    return _Saved.apply((*x.shape[:2], w.shape[2]), x, w)


def _adamw(params, grads, mu, nu, step, lr, **_):
    return params[0].new_empty((), dtype=torch.float32)


@contextlib.contextmanager
def kernel_standins() -> Iterator[None]:
    """The kernels on the meta device stood in for by what their wrappers
    allocate (``ops.meta_trace`` routes the ops to ``kernels.ref``'s plain
    versions, whose places these take, and the scans to ``trace_ops``'
    operators); AdamW in place."""
    from repro_torch.kernels import ops, ref, trace_ops
    swaps = {(ref, "flash_attention_ref"): _flash, (ref, "decode_attention_ref"): _decode,
             (ref, "moe_gmm_ref"): _gmm, (trace_ops, "adamw_update"): _adamw}
    kept = {key: getattr(*key) for key in swaps}
    try:
        for (mod, name), fn in swaps.items():
            setattr(mod, name, fn)
        with ops.meta_trace():
            yield
    finally:
        for (mod, name), fn in kept.items():
            setattr(mod, name, fn)


def meta_params(cfg: ArchConfig) -> dict:
    """``init_params(cfg)``'s tree as new meta tensors: its shapes and
    dtypes, no storage.  The tree of one period of layers is drawn once (on
    fake tensors) and its decoder blocks, stacked over the periods, given
    ``cfg``'s count of them."""
    p = period(cfg)
    spec = _param_specs(with_layers(cfg, p))
    groups = cfg.n_layers // p
    return {k: _build(v, groups if k == "blocks" else None) for k, v in spec.items()}


@functools.lru_cache(maxsize=64)
def _param_specs(cfg: ArchConfig):
    """The shape and dtype of every leaf of ``init_params(cfg)``, from a draw
    on fake tensors, in the tree's structure."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return _specs(T.init_params(cfg, torch.Generator().manual_seed(0)))


class _Spec:
    """A leaf's shape and dtype."""

    def __init__(self, t: torch.Tensor):
        self.shape, self.dtype = tuple(t.shape), t.dtype


def _specs(tree):
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_specs(v) for v in tree)
    return _Spec(tree)


def _build(spec, lead: Optional[int] = None):
    """Meta tensors of ``spec``'s shapes, the first dimension ``lead`` where
    given."""
    if isinstance(spec, dict):
        return {k: _build(v, lead) for k, v in spec.items()}
    if isinstance(spec, tuple):
        return tuple(_build(v, lead) for v in spec)
    shape = spec.shape if lead is None else (lead, *spec.shape[1:])
    return torch.empty(shape, dtype=spec.dtype, device="meta")


def nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def step_peak(run: Callable[[], object], held) -> int:
    """The peak of live bytes of ``run()`` above those of ``held`` (the
    tensors it reads that live before and after it)."""
    mode = LiveBytes()
    mode.hold(held)
    base = mode.live
    with kernel_standins(), mode:
        out = run()
        del out
    return mode.peak - base


# ---------------------------------------------------------------------------
# reckonings


def serve_reckoning(cfg: ArchConfig, batch: int, prompt_len: int, *, turns: bool = True,
                    new_tokens: int = NEW_TOKENS) -> Reckoning:
    """An engine of ``cfg`` serving ``batch`` prompts of ``prompt_len``
    tokens and ``new_tokens`` more (``max_seq_len`` their sum): its weights,
    its caches, and a prefill's peak (a decode step, one token a row, holds
    far less), held twice in turns and once otherwise.  The prefill holds one
    layer's temporaries at a time, so its peak is traced at two periods of
    layers (``serve_step_peak``); weights and caches are counted whole."""
    params = meta_params(cfg)
    caches = T.init_caches(params, cfg, batch, prompt_len + new_tokens)
    return Reckoning(cfg.name, "serve", batch, prompt_len, cfg.n_layers, nbytes(params),
                     nbytes(caches), serve_step_peak(cfg, batch, prompt_len, new_tokens,
                                                     min(cfg.n_layers, 2 * period(cfg))),
                     2 if turns else 1)


def serve_step_peak(cfg: ArchConfig, batch: int, prompt_len: int, new_tokens: int,
                    layers: int) -> int:
    """The live bytes of a prefill of ``cfg`` cut to ``layers`` layers above
    its weights and caches, at its peak."""
    cfg = with_layers(cfg, layers)
    params = meta_params(cfg)
    caches = T.init_caches(params, cfg, batch, prompt_len + new_tokens)
    tokens = torch.empty((batch, prompt_len), dtype=torch.long, device="meta")
    with torch.no_grad():
        return step_peak(lambda: T.prefill(params, cfg, {"tokens": tokens},
                                           seq_len=prompt_len + new_tokens,
                                           caches=caches)[0], (params, caches))


def train_reckoning(cfg: ArchConfig, batch: int, seq_len: int) -> Reckoning:
    """A training step of ``cfg`` on ``batch`` x ``seq_len`` tokens under
    remat with AdamW: weights and fp32 moments, and the step's peak above
    them (the gradients in it), held once."""
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.train_loop import make_train_step
    params = tree_map(lambda p: p.requires_grad_(True), meta_params(cfg))
    opt = init_state(params)
    batch_ = {k: torch.empty((batch, seq_len), dtype=torch.long, device="meta")
              for k in ("tokens", "labels")}
    step = make_train_step(cfg, AdamWConfig(), remat=True)
    peak = step_peak(lambda: step(params, opt, batch_)[2], (params, opt))
    return Reckoning(cfg.name, "train", batch, seq_len, cfg.n_layers, nbytes(params),
                     nbytes(opt.mu) + nbytes(opt.nu), peak, 1)


def period(cfg: ArchConfig) -> int:
    """Layers of one period of ``cfg``'s block pattern (Jamba's 8)."""
    (kinds, _), = T._stack_plan(cfg)
    return len(kinds)


def weights_force_a_cut(cfg: ArchConfig) -> bool:
    """Whether ``cfg``'s weights alone exceed ``CARD_BYTES``: the only case
    in which a run is cut in depth."""
    return nbytes(meta_params(cfg)) > CARD_BYTES


def plan(cfg: ArchConfig, reckon: Callable[[ArchConfig, int], Reckoning],
         batches: Sequence[int] = BATCHES) -> Tuple[Optional[Reckoning], Reckoning]:
    """(the run, the reckoning that decided it).  The run is the largest
    batch of ``batches`` at which ``reckon(cfg, batch)`` fits.  Where the
    weights force a cut, the depth is first cut to the most whole periods of
    layers that fit at the smallest batch.  The run is None where nothing
    fits; the second reckoning then says why: the smallest batch at full
    depth, or at one period where the weights force a cut."""
    if weights_force_a_cut(cfg):
        # the most periods that fit at the smallest batch, by bisection
        p, smallest = period(cfg), batches[-1]
        lo, hi = 0, cfg.n_layers // p            # lo periods fit (0: none), hi + 1 do not
        decided = reckon(with_layers(cfg, p), smallest)
        if not decided.fits():
            return None, decided
        lo = 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if reckon(with_layers(cfg, mid * p), smallest).fits():
                lo = mid
            else:
                hi = mid - 1
        cfg = with_layers(cfg, lo * p)
    for b in batches:
        decided = reckon(cfg, b)
        if decided.fits():
            return decided, decided
    return None, decided


def serve_plan(arch: str, shape: str) -> Tuple[ArchConfig, Optional[Reckoning], Reckoning]:
    """``plan`` of an engine of ``arch`` at ``shape``: "serve_32k" in turns
    over ``BATCHES``; "long_500k" at batch 1 (a full-attention model under
    the reference's serving variant, ``launch.dryrun.serving_variant``), in
    turns where that fits, else once.  Returns (the config, the run or None,
    the deciding reckoning)."""
    from repro_torch.config import get_shape
    cfg = get_arch(arch)
    if shape == "serve_32k":
        run, decided = plan(cfg, lambda c, b: serve_reckoning(c, b, SEQ_LEN[shape]))
        return with_layers(cfg, decided.layers), run, decided
    cfg, _ = serving_variant(cfg, get_shape("long_500k"))
    for turns in (True, False):
        run, decided = plan(cfg, lambda c, b: serve_reckoning(c, b, SEQ_LEN[shape],
                                                              turns=turns), (1,))
        if run is not None:
            break
    return with_layers(cfg, decided.layers), run, decided


def train_plan(arch: str) -> Tuple[ArchConfig, Optional[Reckoning], Reckoning]:
    """``plan`` of training ``arch`` at train_4k over ``BATCHES``: (the
    config, the run or None, the deciding reckoning)."""
    cfg = get_arch(arch)
    run, decided = plan(cfg, lambda c, b: train_reckoning(c, b, SEQ_LEN["train_4k"]))
    return with_layers(cfg, decided.layers), run, decided


def plans() -> Iterator[Tuple[str, ArchConfig, Optional[Reckoning], Reckoning]]:
    """(shape, config, run or None, deciding reckoning) of every pair of
    ``PLAN``."""
    for shape, archs in PLAN.items():
        for arch in archs:
            fn = train_plan if shape == "train_4k" else (lambda a: serve_plan(a, shape))
            yield (shape, *fn(arch))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    for shape, _, run, decided in plans():
        print(f"{shape}: " + (run.line() if run else "not run: " + decided.line()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
