"""The assigned input shapes' lengths on the CPU, against the JAX package.

``chip_smoke.py`` phase 13 runs prefill_32k, decode_32k, long_500k and
train_4k (``src/repro/config/shapes.py``) on the card at full width.  What
those lengths exercise that shorter runs do not is held here at small
widths, float32, with numpy inputs from a seed handed to both packages:

- RoPE at positions 32767, 32768, 524287 and 524319 under both thetas: the
  inverse frequencies bit for bit with those of the JAX models, which XLA
  folds into a constant in float64 (the port took them in fp32, ulps off
  in some components, which the position multiplies), then ``apply_rope``
  and the decode step's rotation, slot and valid mask, against the JAX
  functions compiled as its models run them;
- a windowed model whose prompt is three windows and more, so that the
  ring cache wraps in the prefill and keeps wrapping in decode: the ring's
  contents, the logits and the greedy tokens, through the model and through
  the engine;
- reduced qwen3 under each package's serving variant for long_500k, its
  decode steps from position 524287;
- the byte reckoning that picks phase 13's batches and depths
  (``launch.fit``): its tracer, its counts of weights and caches, and its
  plan, every pair run under 80 GB and the pairs that do not fit refused.

Tolerances: ``tests/test_kernels.py``'s fp32 limit (3e-5) for RoPE, and
1e-4 for the models, as ``tests/test_models.py``: the frameworks sum in
different orders.
"""
import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.config import get_shape as jax_get_shape  # noqa: E402
from repro.config import reduced as jax_reduced  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train.checkpoint import _flatten  # noqa: E402
from repro_torch.config import get_arch, get_shape, reduced, reduced_grouped  # noqa: E402
from repro_torch.launch import fit  # noqa: E402
from repro_torch.launch.dryrun import serving_variant, with_layers  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

ROPE_TOL = dict(atol=3e-5, rtol=3e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
POSITIONS = (32767, 32768, 524287, 524319)     # decode_32k's and long_500k's, and past them


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               **(tol or MODEL_TOL))


#: reduced with their published grouping of query heads (``config.reduced_grouped``)
GROUPED = ("deepseek-67b", "pixtral-12b")


def _pair(arch, **kw):
    """The same reduced config at float32 in both packages (``GROUPED``'s
    with their G)."""
    if arch in GROUPED:
        t = dataclasses.replace(reduced_grouped(get_arch(arch)), dtype="float32", **kw)
        j = dataclasses.replace(jax_reduced(jax_get_arch(arch), d_model=t.d_model),
                                n_heads=t.n_heads, n_kv_heads=t.n_kv_heads, dtype="float32",
                                **kw)
        return j, t
    j = dataclasses.replace(jax_reduced(jax_get_arch(arch)), dtype="float32", **kw)
    t = dataclasses.replace(reduced(get_arch(arch)), dtype="float32", **kw)
    return j, t


def _model(arch, seed, **kw):
    jcfg, tcfg = _pair(arch, **kw)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jparams, params_from_jax(_flatten(jparams), device="cpu")


# ---------------------------------------------------------------------------
# RoPE at the assigned lengths


@pytest.mark.parametrize("theta", [1e4, 1e6, 5e5])
@pytest.mark.parametrize("head_dim", [64, 96, 120, 128, 256])
def test_rope_inverse_frequencies_are_the_references_bit_for_bit(theta, head_dim):
    """The frequencies of the JAX models: compiled, XLA folds them into a
    constant in float64.  The port took them in fp32, 10 to 25 of a head's
    frequencies an ulp or two away (qwen3's 25 of 64), and at position
    524287 the JAX model's decode logits and the port's parted by 2e-4."""
    got = tlayers.rope_freqs(head_dim, theta).numpy()
    want = np.asarray(jax.jit(lambda: jlayers.rope_freqs(head_dim, theta))())
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("head_dim", [64, 120, 128])
def test_apply_rope_at_the_assigned_lengths_matches_jax(theta, head_dim):
    rng = np.random.default_rng(80)
    pos = np.array([list(POSITIONS) + [0, 7]] * 2)
    x = rng.standard_normal((2, pos.shape[1], 3, head_dim)).astype(np.float32)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = jax.jit(jlayers.apply_rope, static_argnums=2)(jnp.asarray(x),
                                                         jnp.asarray(pos, jnp.int32), theta)
    _close(got, want, **ROPE_TOL)


@pytest.mark.parametrize("pos", POSITIONS)
@pytest.mark.parametrize("arch,window,cap", [
    ("qwen3-1.7b", 4096, 4096),            # long_500k's serving variant: a 4096-slot ring
    ("h2o-danube-3-4b", 4096, 4096),       # h2o's own window, theta 1e4
    ("h2o-danube-3-4b", 4096, 5000),       # a ring longer than the window: masked slots
    # long_500k's serving variant of the rest: G 8 at theta 1e4, G 4 at theta 1e6,
    # and seamless's decoder self-attention (heads of 64, theta 1e4)
    ("deepseek-67b", 4096, 4096),
    ("pixtral-12b", 4096, 4096),
    ("seamless-m4t-large-v2", 4096, 4096),
])
def test_decode_step_at_the_assigned_lengths_matches_jax(arch, window, cap, pos):
    """One decode step's attention at ``pos`` against a cache of ``cap``
    slots, full of earlier keys: the rotation of q and k at ``pos``, the
    slot ``pos % cap`` written, the valid mask after the write (every slot,
    or those past ``pos - window``), against JAX's step, with ``pos`` as the
    eager step's int and as the captured step's device scalar."""
    jcfg, tcfg = _pair(arch, sliding_window=window)
    if arch in GROUPED:
        full = get_arch(arch)
        assert tcfg.n_heads // tcfg.n_kv_heads == full.n_heads // full.n_kv_heads
    jp = jattn.attn_init(jax.random.PRNGKey(81), jcfg, jnp.float32)
    tp = params_from_jax(_flatten(jp), device="cpu")
    rng = np.random.default_rng(82)
    B, hd = 2, tcfg.resolved_head_dim
    x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, cap, tcfg.n_kv_heads, hd)).astype(np.float32)
              for _ in range(2))
    step_fn = jax.jit(jattn.decode_step_attention, static_argnums=2)
    jy, jc = step_fn(jp, jnp.asarray(x), jcfg, jnp.int32(pos),
                     {"k": jnp.asarray(kc), "v": jnp.asarray(vc)})
    for p in (pos, torch.tensor(pos)):
        cache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
        step = tattn.decode_step_inputs(tcfg, p, B, cap, "cpu")
        ty, cache = tattn.decode_step_attention(tp, torch.from_numpy(x), tcfg, step, cache)
        _close(ty, jy)
        _close(cache["k"], jc["k"])
        _close(cache["v"], jc["v"])
        j = np.arange(cap)
        abs_pos = pos - ((pos - j) % cap)
        want = (abs_pos >= 0) & (abs_pos > pos - window)
        np.testing.assert_array_equal(step.valid.numpy(), np.broadcast_to(want, (B, cap)))


class _HostData(TorchDispatchMode):
    """Raises on a tensor made from host data (``aten.lift_fresh``, what
    ``torch.tensor`` dispatches): on the card that is a copy from pageable
    host memory, which a CUDA graph capture refuses."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.lift_fresh, torch.ops.aten.lift_fresh_copy):
            raise AssertionError(f"{func}: a tensor made from host data")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "h2o-danube-3-4b", "rwkv6-1.6b",
                                  "mixtral-8x7b", "jamba-v0.1-52b", "seamless-m4t-large-v2",
                                  "pixtral-12b", "phi3.5-moe-42b-a6.6b", "deepseek-67b"])
def test_the_captured_steps_make_no_tensor_from_host_data(arch):
    """The prefill and the decode step that the engine captures make every
    tensor on the device: the frequencies' theta was first made a tensor on
    the card, and every capture on the H100 refused the copy.  Each model on
    the inputs of the JAX package's spec: seamless's ``enc_embeds`` beside
    its tokens, pixtral's ``embeds`` in their place."""
    cfg = dataclasses.replace(reduced(get_arch(arch)), dtype="float32")
    params = TT.init_params(cfg, torch.Generator().manual_seed(0))
    caches = TT.init_caches(params, cfg, 2, 16)
    toks = torch.zeros((2, 5), dtype=torch.long)
    batch = {"tokens": toks}
    if cfg.encdec is not None:
        batch["enc_embeds"] = torch.zeros((2, cfg.encdec.max_source_positions,
                                           cfg.frontend.embed_dim))
    elif cfg.frontend is not None:
        batch = {"embeds": torch.zeros((2, 5, cfg.frontend.embed_dim))}
    with torch.inference_mode(), _HostData():
        _, out = TT.prefill(params, cfg, batch, seq_len=16, caches=caches)
        TT.decode_step(params, cfg, toks[:, :1], torch.zeros((), dtype=torch.long), out)
    with pytest.raises(AssertionError, match="host data"), _HostData():
        torch.tensor(1e4)


# ---------------------------------------------------------------------------
# a ring cache that wraps in the prefill and in decode


WINDOW = 8
PROMPT = 3 * WINDOW + 5           # three windows and a remainder


def _greedy_jax(jcfg, jparams, toks, steps, seq_len, start=None):
    """JAX's prefill then ``steps`` greedy decode steps (from position
    ``start``, the prompt's length by default): logits of each, the caches
    after the prefill and at the end, the tokens."""
    logits, caches = JT.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)},
                                seq_len=seq_len)
    after_prefill = caches
    out, tok = [logits], np.asarray(jnp.argmax(logits, -1))
    pos = toks.shape[1] if start is None else start
    for i in range(steps):
        logits, caches = JT.decode_step(jparams, jcfg, jnp.asarray(tok, jnp.int32),
                                        jnp.int32(pos + i), caches)
        out.append(logits)
        tok = np.asarray(jnp.argmax(logits, -1))
    return out, after_prefill, caches


def _greedy_torch(tcfg, tparams, toks, steps, seq_len, start=None, tensor_pos=False):
    logits, caches = TT.prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks)},
                                seq_len=seq_len)
    after_prefill = {k: v.clone() for k, v in caches["layers"][0].items()}
    out, tok = [logits], logits.argmax(-1)
    pos = toks.shape[1] if start is None else start
    for i in range(steps):
        p = torch.tensor(pos + i) if tensor_pos else pos + i
        logits, caches = TT.decode_step(tparams, tcfg, tok, p, caches)
        out.append(logits)
        tok = logits.argmax(-1)
    return out, after_prefill, caches


@pytest.mark.parametrize("tensor_pos", [False, True])
def test_a_ring_that_wraps_in_prefill_and_decode_matches_jax(tensor_pos):
    """Reduced h2o-danube-3-4b with an 8-slot window under a 29-token
    prompt: the prefill keeps the last 8 keys rolled so that slot j holds
    position p = j (mod 8), and 8 decode steps overwrite every slot once
    more; the ring's contents, every step's logits and the greedy tokens
    against JAX's prefill and decode."""
    jcfg, tcfg, jparams, tparams = _model("h2o-danube-3-4b", 83, sliding_window=WINDOW)
    toks = np.random.default_rng(83).integers(0, jcfg.vocab_size, (2, PROMPT))
    seq_len = PROMPT + 16
    assert tattn.kv_cache_capacity(tcfg, seq_len) == WINDOW < PROMPT
    jout, jpre, jfin = _greedy_jax(jcfg, jparams, toks, 8, seq_len)
    tout, tpre, tfin = _greedy_torch(tcfg, tparams, toks, 8, seq_len, tensor_pos=tensor_pos)
    for name in ("k", "v"):
        _close(tpre[name], jpre["layers"][0][name])
        _close(tfin["layers"][0][name], jfin["layers"][0][name])
    for t, j in zip(tout, jout):
        _close(t, j)
    assert [int(t.argmax()) for t in tout] == [int(np.argmax(j)) for j in jout]


def test_the_engine_serves_a_wrapped_ring_as_jax_does():
    """The same model through the port's ``ServingEngine`` (its prefill and
    decode step functions, which the card captures): the greedy tokens of
    JAX's prefill and decode steps."""
    jcfg, tcfg, jparams, tparams = _model("h2o-danube-3-4b", 84, sliding_window=WINDOW)
    toks = np.random.default_rng(84).integers(0, jcfg.vocab_size, (2, PROMPT))
    new = 9
    eng = ServingEngine(tcfg, batch_slots=2, max_seq_len=PROMPT + new + 1, device="cpu",
                        params=tparams)
    got = eng.generate(toks.tolist(), max_new_tokens=new)
    jout, _, _ = _greedy_jax(jcfg, jparams, toks, new - 1, PROMPT + new + 1)
    want = np.stack([np.asarray(jnp.argmax(j, -1))[:, 0] for j in jout], 1)
    assert got == want.tolist()


# ---------------------------------------------------------------------------
# long_500k's serving variant


def _jax_serving_variant(cfg, shape):
    """The JAX package's ``launch.dryrun.serving_variant``; its module sets
    the host platform's device count as it is imported, which the rest of
    this process must not see."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import serving_variant as jvariant
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return jvariant(cfg, shape)


@pytest.mark.parametrize("tensor_pos", [False, True])
def test_long_500k_serving_variant_decodes_from_524287_as_jax_does(tensor_pos):
    """Reduced qwen3-1.7b (full attention, theta 1e6) under each package's
    serving variant for long_500k (window 4096), its caches made for
    524288 + 16 positions (a 4096-slot ring), a 5-token prompt, then 8
    decode steps from position 524287: the ring's slot and mask arithmetic
    and RoPE there, against JAX."""
    j0, t0 = _pair("qwen3-1.7b")
    jcfg, jnote = _jax_serving_variant(j0, jax_get_shape("long_500k"))
    tcfg, tnote = serving_variant(t0, get_shape("long_500k"))
    assert jnote == tnote != ""
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.sliding_window == 4096
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(85))
    tparams = params_from_jax(_flatten(jparams), device="cpu")
    toks = np.random.default_rng(85).integers(0, jcfg.vocab_size, (2, 5))
    seq_len, start = 524288 + 16, 524287
    assert tattn.kv_cache_capacity(tcfg, seq_len) == 4096
    jout, _, jfin = _greedy_jax(jcfg, jparams, toks, 8, seq_len, start)
    tout, _, tfin = _greedy_torch(tcfg, tparams, toks, 8, seq_len, start, tensor_pos)
    for t, j in zip(tout, jout):
        _close(t, j)
    _close(tfin["layers"][0]["k"], jfin["layers"][0]["k"])


# ---------------------------------------------------------------------------
# the byte reckoning of phase 13 (launch.fit)


def test_live_bytes_holds_a_storage_until_its_last_tensor_dies():
    mode = fit.LiveBytes()
    with mode:
        a = torch.empty(1000, device="meta")                  # 4000 bytes
        b = a[10:]                                            # a view: no new storage
        c = torch.empty((10, 50), dtype=torch.bfloat16, device="meta")   # 1000 bytes
        assert (mode.live, mode.peak) == (5000, 5000)
        del a
        assert mode.live == 5000                              # b keeps a's storage
        del b
        d = c.float()                                         # 2000 bytes
        assert (mode.live, mode.peak) == (3000, 5000)
        del c, d
    assert mode.live == 0


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "h2o-danube-3-4b", "jamba-v0.1-52b",
                                  "rwkv6-1.6b", "mixtral-8x7b", "seamless-m4t-large-v2",
                                  "pixtral-12b"])
def test_reckoned_weights_and_caches_are_the_models(arch):
    """A reckoning's weights and caches are the bytes of the tensors the
    engine draws and allocates (a windowed model's ring at its window; an
    enc-dec model's cross K/V buffers over its frames), its step's peak
    positive; ``meta_params`` at two periods of layers, built from one
    period's tree, is the drawn tree's shapes, an encoder's three layers
    too (the tree once kept one encoder layer: seamless-m4t-large-v2's
    weights were reckoned at 2.72 GB, against 4.07 drawn on the card)."""
    cfg = dataclasses.replace(reduced(get_arch(arch)), dtype="bfloat16",
                              sliding_window=8 if arch == "h2o-danube-3-4b" else None)
    cfg = dataclasses.replace(with_layers(cfg, 2 * fit.period(cfg)),
                              encdec=cfg.encdec and dataclasses.replace(cfg.encdec,
                                                                        encoder_layers=3))
    params = TT.init_params(cfg, torch.Generator().manual_seed(0))
    rec = fit.serve_reckoning(cfg, 2, 24, new_tokens=8)
    assert rec.weights == fit.nbytes(params)
    cross = (fit.nbytes(TT.init_cross_caches(params, cfg, 2, cfg.encdec.max_source_positions))
             if cfg.encdec else 0)
    assert rec.state == fit.nbytes(TT.init_caches(params, cfg, 2, 32)) + cross
    assert rec.step > 0 and (rec.batch, rec.seq_len, rec.pools) == (2, 24, 2)
    meta = fit.meta_params(cfg)
    assert [(tuple(m.shape), m.dtype) for m in tlayers.tree_leaves(meta)] == \
        [(tuple(p.shape), p.dtype) for p in tlayers.tree_leaves(params)]
    assert fit.serve_reckoning(cfg, 2, 24, turns=False).pools == 1


def test_a_training_reckoning_counts_weights_moments_and_the_step():
    cfg = dataclasses.replace(reduced(get_arch("qwen3-1.7b")), dtype="bfloat16")
    rec = fit.train_reckoning(cfg, 2, 32)
    w = fit.nbytes(TT.init_params(cfg, torch.Generator().manual_seed(0)))
    assert rec.weights == w and rec.state == 4 * w     # fp32 moments of bf16 weights
    assert rec.step >= w                               # the gradients live in the step
    assert rec.pools == 1


@functools.lru_cache(maxsize=1)
def _plans():
    """``fit.plans()`` by (shape, arch), reckoned once for this module."""
    return {(shape, cfg.name): (cfg, run, decided) for shape, cfg, run, decided in fit.plans()}


def _reckon(shape):
    if shape == "train_4k":
        return lambda c, b: fit.train_reckoning(c, b, fit.SEQ_LEN[shape])
    return lambda c, b: fit.serve_reckoning(c, b, fit.SEQ_LEN[shape])


def test_the_plan_fits_the_card_and_refuses_what_does_not():
    """Phase 13's plan: every pair run fits 80 GB at the largest batch that
    fits at its depth; the depth is the whole model's where that fits at
    batch 1, else the most whole periods of layers that fit there, else the
    longest prefix of one period that fits; long_500k runs at batch 1 (qwen3
    under the serving variant); a pair of which not one layer fits at batch
    1 is refused, its reckoning at one layer.  The first pairs the card ran
    keep their batch and depth: qwen3, phi4-mini, h2o and rwkv6 whole,
    mixtral at 16 and Jamba at 8 of 32 layers; mixtral's and Jamba's
    long_500k refused; rwkv6 trains at batch 4, not 8, under the training
    slack measured since (1.44 x a step's peak, mixtral-8x7b at batch 8)."""
    pairs = _plans()
    assert set(pairs) == {(s, a) for s, archs in fit.PLAN.items() for a in archs}
    for shape, archs in fit.PLAN.items():
        assert sorted(archs) == sorted(fit.PLAN["serve_32k"]) and len(archs) == 10
    for (shape, arch), (cfg, run, decided) in pairs.items():
        full = get_arch(arch)
        if run is None:
            assert not decided.fits() and decided.total > fit.CARD_BYTES
            assert decided.layers == 1
            continue
        assert run.fits() and run.total <= fit.CARD_BYTES
        assert run.seq_len == fit.SEQ_LEN[shape] and cfg.n_layers == run.layers
        assert run.batch in fit.BATCHES
        reckon = _reckon(shape)
        if shape == "long_500k":
            assert run.batch == 1
            continue
        if run.batch < fit.BATCHES[0]:                  # the largest batch that fits
            bigger = fit.BATCHES[fit.BATCHES.index(run.batch) - 1]
            assert not reckon(cfg, bigger).fits()
        if run.layers == full.n_layers:
            continue
        p = fit.period(full)                            # cut: one more does not fit at B 1
        assert not reckon(full, fit.BATCHES[-1]).fits()
        step = p if run.layers >= p else 1
        assert run.layers % step == 0
        assert not reckon(with_layers(full, run.layers + step), fit.BATCHES[-1]).fits()
    ran = {(s, a): (run.batch, run.layers) for (s, a), (_, run, _) in pairs.items() if run}
    assert {k: ran[k] for k in [
        ("serve_32k", "qwen3-1.7b"), ("serve_32k", "phi4-mini-3.8b"),
        ("serve_32k", "h2o-danube-3-4b"), ("serve_32k", "rwkv6-1.6b"),
        ("serve_32k", "mixtral-8x7b"), ("serve_32k", "jamba-v0.1-52b"),
        ("long_500k", "rwkv6-1.6b"), ("long_500k", "qwen3-1.7b"),
        ("train_4k", "qwen3-1.7b"), ("train_4k", "rwkv6-1.6b")]} == {
        ("serve_32k", "qwen3-1.7b"): (4, 28), ("serve_32k", "phi4-mini-3.8b"): (4, 32),
        ("serve_32k", "h2o-danube-3-4b"): (4, 24), ("serve_32k", "rwkv6-1.6b"): (8, 24),
        ("serve_32k", "mixtral-8x7b"): (1, 16), ("serve_32k", "jamba-v0.1-52b"): (1, 8),
        ("long_500k", "rwkv6-1.6b"): (1, 24), ("long_500k", "qwen3-1.7b"): (1, 28),
        ("train_4k", "qwen3-1.7b"): (2, 28), ("train_4k", "rwkv6-1.6b"): (4, 24)}
    assert pairs[("long_500k", "rwkv6-1.6b")][1].pools == 1
    for arch in ("mixtral-8x7b", "jamba-v0.1-52b"):
        assert nbytes_of(arch) > fit.CARD_BYTES          # the weights alone
        assert pairs[("long_500k", arch)][1] is None
    assert pairs[("long_500k", "qwen3-1.7b")][0].sliding_window == 4096


def nbytes_of(arch):
    return fit.nbytes(fit.meta_params(get_arch(arch)))


@pytest.mark.parametrize("arch,layers", [("qwen3-1.7b", 6), ("jamba-v0.1-52b", 24),
                                         ("mixtral-8x7b", 5), ("rwkv6-1.6b", 7),
                                         ("pixtral-12b", 5), ("seamless-m4t-large-v2", 6)])
def test_a_prefills_peak_at_two_periods_is_the_whole_stacks(arch, layers):
    """``serve_reckoning`` traces a decoder's prefill at two periods of
    layers: it holds one layer's temporaries at a time, so its peak above
    weights and caches is the whole stack's (pixtral's from its ``embeds``).
    An enc-dec prefill (seamless, the encoder cut with the decoder) holds
    the cross K/V of every decoder layer through the decoder: two periods
    undercount it, and the reckoning traces it whole."""
    cfg = with_layers(dataclasses.replace(reduced(get_arch(arch)), dtype="bfloat16"), layers)
    whole = fit.serve_step_peak(cfg, 2, 40, 8, layers)
    assert fit.serve_reckoning(cfg, 2, 40, new_tokens=8).step == whole
    two = fit.serve_step_peak(cfg, 2, 40, 8, 2 * fit.period(cfg))
    if cfg.encdec is None:
        assert two == whole
    else:
        assert two < whole
