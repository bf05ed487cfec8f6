"""What a serving or training run of one configuration holds on one card,
reckoned before it allocates: the depth is cut where the whole model does
not fit ``CARD_BYTES`` at the smallest of ``BATCHES`` (to the most whole
periods of its block pattern that fit, else to the longest prefix of one
period that fits), and the batch is the largest of ``BATCHES`` that fits.

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
  cache is a ring of min(max_seq_len, window) slots, ``init_caches``; an
  enc-dec model's cross K/V buffers and their valid mask,
  ``init_cross_caches``); training, AdamW's fp32 moments;
- ``inputs``: the step's batch (``step_inputs``), held twice: the
  caller's and the static copy a captured step reads (pixtral's
  ``embeds`` at 32768 tokens are 0.67 GB);
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

``total = weights + state + inputs + held + RESERVE``, ``held`` the larger of
``pools * ALLOCATOR_SLACK[kind] * step`` and ``pools * step +
ALLOCATOR_FLOOR[kind]``,
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

from repro_torch.config import ArchConfig, InputShape, StepKind, get_arch
from repro_torch.launch.dryrun import input_specs, serving_variant, with_layers
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
#: phase 13): a 32768-token prefill's graph pool and the eager prefill
#: beside it held 2.43-3.60 x the traced peak between them (3.60: pixtral-12b
#: at batch 2), a 524288-token prefill held once 1.37-1.58 x; a training step
#: 1.05-1.44 x (1.44: mixtral-8x7b, 3 layers at batch 8)
ALLOCATOR_SLACK = {"serve": 1.75, "train": 1.45}
#: the least the caching allocator holds beside the copies of a step's peak,
#: by kind: a training step's reserved peak stood 2.3-13.7 GB above its
#: allocated one on the H100 (chip_smoke.py phase 13), not in proportion to
#: the step (mixtral-8x7b: 13.7 GB over a 16.6 GB step at 3 layers and batch
#: 4), which slack alone does not cover where the step is small
ALLOCATOR_FLOOR = {"serve": 0.0, "train": 15.0e9}
#: bytes held beside the model: the CUDA context (0.75 GiB beside torch's
#: allocator on the H100), cuBLAS's workspaces, the logits a run keeps
RESERVE = 1.5e9
#: the new tokens a served request generates after its prompt
NEW_TOKENS = 32

#: the ten assigned architectures under the assigned shapes one card runs
#: (``config/shapes.py``); the plan decides which pairs fit, at what batch
#: and depth: "serve_32k" a prefill_32k prompt then decode_32k steps through one
#: engine; "long_500k" a 524288-token prompt then decode steps, at batch 1;
#: "train_4k" training steps of 4096 tokens
PLAN: Dict[str, Tuple[str, ...]] = {
    "serve_32k": ("qwen3-1.7b", "phi4-mini-3.8b", "h2o-danube-3-4b", "rwkv6-1.6b",
                  "mixtral-8x7b", "jamba-v0.1-52b", "deepseek-67b", "phi3.5-moe-42b-a6.6b",
                  "pixtral-12b", "seamless-m4t-large-v2"),
    "long_500k": ("rwkv6-1.6b", "qwen3-1.7b", "h2o-danube-3-4b", "mixtral-8x7b",
                  "jamba-v0.1-52b", "phi4-mini-3.8b", "deepseek-67b", "phi3.5-moe-42b-a6.6b",
                  "pixtral-12b", "seamless-m4t-large-v2"),
    "train_4k": ("qwen3-1.7b", "rwkv6-1.6b", "phi4-mini-3.8b", "h2o-danube-3-4b",
                 "mixtral-8x7b", "jamba-v0.1-52b", "phi3.5-moe-42b-a6.6b", "deepseek-67b",
                 "seamless-m4t-large-v2", "pixtral-12b"),
}
#: sequence length of each of ``PLAN``'s shapes
SEQ_LEN = {"serve_32k": 32768, "long_500k": 524288, "train_4k": 4096}


@dataclasses.dataclass(frozen=True)
class Reckoning:
    """The bytes of one run of ``arch`` (``kind`` "serve" or "train") at
    ``batch`` x ``seq_len`` with ``layers`` decoder layers (``enc_layers``
    encoder layers beside them, ``kinds`` the block kinds of a stack that
    is one period of mixed kinds); see the module's docstring."""
    arch: str
    kind: str
    batch: int
    seq_len: int
    layers: int
    weights: int
    state: int
    step: int
    pools: int
    inputs: int = 0
    enc_layers: int = 0
    kinds: Tuple[str, ...] = ()

    @property
    def slack(self) -> float:
        return ALLOCATOR_SLACK[self.kind]

    @property
    def held(self) -> float:
        """What the allocator holds for the steps' peaks."""
        return max(self.pools * self.slack * self.step,
                   self.pools * self.step + ALLOCATOR_FLOOR[self.kind])

    @property
    def total(self) -> float:
        return self.weights + self.state + self.inputs + self.held + RESERVE

    def fits(self, budget: float = CARD_BYTES) -> bool:
        return self.total <= budget

    def depth(self) -> str:
        """The layers the run keeps, in words."""
        out = f"{self.layers} layers"
        if self.enc_layers:
            out = f"{self.layers} decoder and {self.enc_layers} encoder layers"
        if self.kinds:
            out += f" ({', '.join(self.kinds)})"
        return out

    def line(self) -> str:
        what = "caches" if self.kind == "serve" else "moments"
        return (f"{self.arch} {self.kind} B {self.batch} x {self.seq_len}, {self.depth()}: "
                f"weights {self.weights / 1e9:.2f} GB, {what} {self.state / 1e9:.2f} GB, inputs "
                f"{self.inputs / 1e9:.2f} GB, a "
                f"step's peak {self.step / 1e9:.2f} GB x {self.pools} held as "
                f"{self.held / 1e9:.2f}, "
                f"reserve {RESERVE / 1e9:.1f} GB: {self.total / 1e9:.2f} GB "
                + ("fits" if self.fits() else "does not fit") + f" {CARD_BYTES / 1e9:.0f} GB")


def _reckoning(cfg: ArchConfig, kind: str, batch: int, seq_len: int, **figures) -> Reckoning:
    kinds = cfg.block_kinds()
    mixed = len(set(kinds)) > 1 and period(cfg) == cfg.n_layers
    return Reckoning(cfg.name, kind, batch, seq_len, cfg.n_layers,
                     enc_layers=cfg.encdec.encoder_layers if cfg.encdec else 0,
                     kinds=tuple(k.value for k in kinds) if mixed else (), **figures)


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
    fake tensors, ``with_layers`` cutting an encoder to as many layers) and
    its decoder blocks, stacked over the periods, given ``cfg``'s count of
    them, an encoder's blocks its own."""
    p = period(cfg)
    spec = _param_specs(with_layers(cfg, p))
    lead = {"blocks": cfg.n_layers // p}
    if cfg.encdec is not None:
        lead["enc_blocks"] = cfg.encdec.encoder_layers
    return {k: _build(v, lead.get(k)) for k, v in spec.items()}


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


def step_inputs(cfg: ArchConfig, batch: int, seq_len: int, train: bool = False) -> dict:
    """The batch of a prefill (or a training step) of ``batch`` x
    ``seq_len`` as meta tensors: the JAX package's spec
    (``launch.dryrun.input_specs``)."""
    step = StepKind.TRAIN if train else StepKind.PREFILL
    return input_specs(cfg, InputShape("fit", seq_len, batch, step))


def serve_state(params, cfg: ArchConfig, batch: int, max_seq_len: int):
    """The engine's static caches of a batch shape: ``init_caches``' tree,
    and an enc-dec model's cross K/V buffers and valid mask over its
    ``max_source_positions`` frames (``init_cross_caches``)."""
    caches = T.init_caches(params, cfg, batch, max_seq_len)
    if cfg.encdec is None:
        return caches, {}
    return caches, T.init_cross_caches(params, cfg, batch, cfg.encdec.max_source_positions)


def serve_reckoning(cfg: ArchConfig, batch: int, prompt_len: int, *, turns: bool = True,
                    new_tokens: int = NEW_TOKENS) -> Reckoning:
    """An engine of ``cfg`` serving ``batch`` prompts of ``prompt_len``
    tokens and ``new_tokens`` more (``max_seq_len`` their sum): its weights,
    its caches, and a prefill's peak (a decode step, one token a row, holds
    far less), held twice in turns and once otherwise.  A decoder's prefill
    holds one layer's temporaries at a time, so its peak is traced at two
    periods of layers (``serve_step_peak``); an enc-dec prefill holds the
    cross K/V of every decoder layer from the encoder's end to its own, so
    it is traced whole.  Weights and caches are counted whole."""
    params = meta_params(cfg)
    caches, cross = serve_state(params, cfg, batch, prompt_len + new_tokens)
    layers = cfg.n_layers if cfg.encdec is not None else min(cfg.n_layers, 2 * period(cfg))
    return _reckoning(cfg, "serve", batch, prompt_len, weights=nbytes(params),
                      state=nbytes(caches) + nbytes(cross),
                      inputs=2 * nbytes(step_inputs(cfg, batch, prompt_len)),
                      step=serve_step_peak(cfg, batch, prompt_len, new_tokens, layers),
                      pools=2 if turns else 1)


def serve_step_peak(cfg: ArchConfig, batch: int, prompt_len: int, new_tokens: int,
                    layers: int) -> int:
    """The live bytes of a prefill of ``cfg`` cut to ``layers`` layers
    (``with_layers``: an encoder's too) above its weights and caches, at its
    peak."""
    cfg = with_layers(cfg, layers)
    params = meta_params(cfg)
    caches, _ = serve_state(params, cfg, batch, prompt_len + new_tokens)
    inputs = step_inputs(cfg, batch, prompt_len)
    with torch.no_grad():
        return step_peak(lambda: T.prefill(params, cfg, inputs, seq_len=prompt_len + new_tokens,
                                           caches=caches)[0], (params, caches, inputs))


def train_reckoning(cfg: ArchConfig, batch: int, seq_len: int) -> Reckoning:
    """A training step of ``cfg`` on ``batch`` x ``seq_len`` tokens under
    remat with AdamW: weights and fp32 moments, and the step's peak above
    them (the gradients in it), held once."""
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.train_loop import make_train_step
    params = tree_map(lambda p: p.requires_grad_(True), meta_params(cfg))
    opt = init_state(params)
    inputs = step_inputs(cfg, batch, seq_len, train=True)
    step = make_train_step(cfg, AdamWConfig(), remat=True)
    peak = step_peak(lambda: step(params, opt, inputs)[2], (params, opt, inputs))
    return _reckoning(cfg, "train", batch, seq_len, weights=nbytes(params),
                      state=nbytes(opt.mu) + nbytes(opt.nu), inputs=2 * nbytes(inputs),
                      step=peak, pools=1)


def period(cfg: ArchConfig) -> int:
    """Layers of one period of ``cfg``'s block pattern (Jamba's 8)."""
    (kinds, _), = T._stack_plan(cfg)
    return len(kinds)


def _most(fits: Callable[[int], bool], hi: int) -> int:
    """The largest n in 0..``hi`` with ``fits(n)``, ``fits`` falling in n
    (``fits(0)`` is taken as true), by bisection."""
    lo = 0
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid - 1
    return lo


def cut(cfg: ArchConfig, reckon: Callable[[ArchConfig, int], Reckoning],
        batch: int) -> Tuple[Optional[ArchConfig], Reckoning]:
    """(``cfg`` at the most layers that fit at ``batch``, the reckoning that
    decided it).  The depth is the whole model's where it fits; else the
    most whole periods of the block pattern that fit; else, where not even
    one period fits, the longest prefix of one period that fits.  Where not
    one layer fits, (None, the reckoning at one layer)."""
    whole = reckon(cfg, batch)
    if whole.fits():
        return cfg, whole
    p = period(cfg)
    n = p * _most(lambda k: reckon(with_layers(cfg, k * p), batch).fits(), cfg.n_layers // p - 1)
    if n == 0:
        n = _most(lambda k: reckon(with_layers(cfg, k), batch).fits(), p - 1)
    if n == 0:
        return None, reckon(with_layers(cfg, 1), batch)
    return with_layers(cfg, n), reckon(with_layers(cfg, n), batch)


def plan(cfg: ArchConfig, reckon: Callable[[ArchConfig, int], Reckoning],
         batches: Sequence[int] = BATCHES) -> Tuple[Optional[Reckoning], Reckoning]:
    """(the run, the reckoning that decided it).  The depth is cut where the
    whole model does not fit at the smallest batch of ``batches``
    (``cut``); the run is the largest batch at which ``reckon(cfg, batch)``
    fits at that depth.  The run is None where not one layer fits at the
    smallest batch; the second reckoning then says why."""
    cfg, decided = cut(cfg, reckon, batches[-1])
    if cfg is None:
        return None, decided
    for b in batches[:-1]:
        at = reckon(cfg, b)
        if at.fits():
            return at, at
    return decided, decided


def serve_plan(arch: str, shape: str) -> Tuple[ArchConfig, Optional[Reckoning], Reckoning]:
    """``plan`` of an engine of ``arch`` at ``shape``: "serve_32k" in turns
    over ``BATCHES``; "long_500k" at batch 1 (a full-attention model under
    the reference's serving variant, ``launch.dryrun.serving_variant``), in
    turns where that keeps as many layers as a run once, else once.  Returns (the config, the run or None,
    the deciding reckoning)."""
    from repro_torch.config import get_shape
    cfg = get_arch(arch)
    if shape == "serve_32k":
        run, decided = plan(cfg, lambda c, b: serve_reckoning(c, b, SEQ_LEN[shape]))
        return with_layers(cfg, decided.layers), run, decided
    cfg, _ = serving_variant(cfg, get_shape("long_500k"))
    # the deeper of the two runs, in turns where both keep as many layers
    tried = [plan(cfg, lambda c, b: serve_reckoning(c, b, SEQ_LEN[shape], turns=turns), (1,))
             for turns in (True, False)]
    run, decided = max(tried, key=lambda t: t[0].layers if t[0] else 0)
    if run is None:
        run, decided = tried[-1]
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
