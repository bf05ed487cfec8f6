"""The rest of the assigned pairs on the CPU: what ``chip_smoke.py`` phase
13 newly runs on the card (seamless-m4t-large-v2, pixtral-12b, phi3.5-moe
and deepseek-67b at prefill_32k/decode_32k, seamless at long_500k, eight
more architectures at train_4k), held at small widths, float32, with numpy
inputs from a seed handed to both packages:

- reduced seamless under long_500k's serving variant (its decoder windowed
  at 4096, its encoder not), a prefill from ``enc_embeds`` (every frame
  valid), then decode steps from position 524287, against JAX's prefill and
  ``decode_step``;
- reduced pixtral (its G 4) prefilled from ``embeds``, then decode steps
  past position 32767, against JAX;
- the byte reckoning's depth rule (``launch.fit.cut``): the whole model
  where it fits at the smallest batch, else the most whole periods, else the
  longest prefix of one period; and its plans of the new pairs: phi3.5-moe
  cut to serve at 32768 tokens, pixtral, Jamba (a prefix of one period) and
  phi3.5-moe cut to train at 4096, each fitting the card; seamless and
  pixtral reckoned on the JAX spec's inputs, seamless's cross K/V counted.

Tolerance: 1e-4 for the models, as ``tests/test_models.py``: the frameworks
sum in different orders.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.config import get_shape as jax_get_shape  # noqa: E402
from repro.config import reduced as jax_reduced  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train.checkpoint import _flatten  # noqa: E402
from repro_torch.config import get_arch, get_shape, reduced, reduced_grouped  # noqa: E402
from repro_torch.launch import fit  # noqa: E402
from repro_torch.launch.dryrun import serving_variant, with_layers  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

MODEL_TOL = dict(atol=1e-4, rtol=1e-4)


def _close(t, j):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               **MODEL_TOL)


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


def _greedy(jcfg, tcfg, jparams, tparams, jbatch, tbatch, steps, seq_len, start, tensor_pos):
    """Both packages' prefill of the batch, then ``steps`` greedy decode
    steps from position ``start``: the logits of each, and the last caches'
    first decoder layer."""
    jl, jc = JT.prefill(jparams, jcfg, jbatch, seq_len=seq_len)
    tl, tc = TT.prefill(tparams, tcfg, tbatch, seq_len=seq_len)
    out = [(tl, jl)]
    jtok, ttok = jnp.argmax(jl, -1), tl.argmax(-1)
    for i in range(steps):
        jl, jc = JT.decode_step(jparams, jcfg, jtok.astype(jnp.int32), jnp.int32(start + i), jc)
        p = torch.tensor(start + i) if tensor_pos else start + i
        tl, tc = TT.decode_step(tparams, tcfg, ttok, p, tc)
        out.append((tl, jl))
        jtok, ttok = jnp.argmax(jl, -1), tl.argmax(-1)
        assert np.asarray(jtok).tolist() == ttok.tolist()
    return out, tc["layers"][0], jc["layers"][0]


@pytest.mark.parametrize("tensor_pos", [False, True])
def test_seamless_long_500k_serving_variant_decodes_from_524287_as_jax_does(tensor_pos):
    """Reduced seamless-m4t-large-v2 under each package's serving variant for
    long_500k (its decoder's self-attention windowed at 4096, its encoder
    bidirectional over every frame), a 6-token prompt beside the JAX spec's
    ``enc_embeds`` (``max_source_positions`` frames, no ``enc_mask``), its
    caches made for 524288 + 16 positions (a 4096-slot ring), then 8 decode
    steps from position 524287: self- and cross-attention, the ring's slot
    and mask arithmetic and RoPE there, against JAX."""
    j0 = dataclasses.replace(jax_reduced(jax_get_arch("seamless-m4t-large-v2")),
                             dtype="float32")
    t0 = dataclasses.replace(reduced(get_arch("seamless-m4t-large-v2")), dtype="float32")
    jcfg, jnote = _jax_serving_variant(j0, jax_get_shape("long_500k"))
    tcfg, tnote = serving_variant(t0, get_shape("long_500k"))
    assert jnote == tnote != "" and dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.sliding_window == 4096 and tcfg.encdec is not None
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(86))
    tparams = params_from_jax(_flatten(jparams), device="cpu")
    rng = np.random.default_rng(86)
    toks = rng.integers(0, jcfg.vocab_size, (2, 6))
    frames = rng.standard_normal((2, tcfg.encdec.max_source_positions,
                                  tcfg.frontend.embed_dim)).astype(np.float32)
    seq_len, start = 524288 + 16, 524287
    assert tattn.kv_cache_capacity(tcfg, seq_len) == 4096
    out, tlayer, jlayer = _greedy(
        jcfg, tcfg, jparams, tparams,
        {"tokens": jnp.asarray(toks, jnp.int32), "enc_embeds": jnp.asarray(frames)},
        {"tokens": torch.from_numpy(toks), "enc_embeds": torch.from_numpy(frames)},
        8, seq_len, start, tensor_pos)
    for t, j in out:
        _close(t, j)
    _close(tlayer["k"], jlayer["k"])


@pytest.mark.parametrize("tensor_pos", [False, True])
def test_pixtral_prefills_from_embeds_then_decodes_past_32767_as_jax_does(tensor_pos):
    """Reduced pixtral-12b with its G 4 (theta 1e6) prefilled from 7 stub
    patch embeddings (the JAX spec's ``embeds`` in place of tokens), its
    caches made for decode_32k's 32768 + 16 positions, then 8 decode steps
    from position 32767: the last slots of the cache, the valid mask and
    RoPE there, against JAX."""
    arch = "pixtral-12b"
    tcfg = dataclasses.replace(reduced_grouped(get_arch(arch)), dtype="float32")
    jcfg = dataclasses.replace(jax_reduced(jax_get_arch(arch), d_model=tcfg.d_model),
                               n_heads=tcfg.n_heads, n_kv_heads=tcfg.n_kv_heads,
                               dtype="float32")
    assert tcfg.n_heads // tcfg.n_kv_heads == 4 and tcfg.encdec is None
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(87))
    tparams = params_from_jax(_flatten(jparams), device="cpu")
    embeds = np.random.default_rng(87).standard_normal(
        (2, 7, tcfg.frontend.embed_dim)).astype(np.float32)
    seq_len, start = 32768 + 16, 32767
    assert tattn.kv_cache_capacity(tcfg, seq_len) == seq_len
    out, tlayer, jlayer = _greedy(jcfg, tcfg, jparams, tparams,
                                  {"embeds": jnp.asarray(embeds)},
                                  {"embeds": torch.from_numpy(embeds)},
                                  8, seq_len, start, tensor_pos)
    for t, j in out:
        _close(t, j)
    _close(tlayer["k"][:, :, start:start + 8], jlayer["k"][:, :, start:start + 8])


# ---------------------------------------------------------------------------
# the depth rule and the plans of the new pairs


def _fake_reckon(per_layer, fixed=0.0, per_batch=0.0):
    """A reckoning of ``fixed`` + ``per_layer`` GB a layer + ``per_batch``
    GB a row, whatever the model: a test of the rule, not of the bytes."""
    def reckon(cfg, batch):
        gb = fixed + per_layer * cfg.n_layers + per_batch * batch
        return fit.Reckoning(cfg.name, "serve", batch, 4096, cfg.n_layers, int(gb * 1e9), 0, 0,
                             1)
    return reckon


@pytest.mark.parametrize("arch,per_layer,fixed,want", [
    ("qwen3-1.7b", 2.0, 0.0, 28),          # 56 GB + reserve: whole
    ("qwen3-1.7b", 4.0, 0.0, 20),          # the most layers (period 1) that fit
    ("jamba-v0.1-52b", 3.0, 0.0, 24),      # three whole periods of 8 fit
    ("jamba-v0.1-52b", 20.0, 0.0, 4),      # not one period: the longest prefix
    ("jamba-v0.1-52b", 90.0, 0.0, None),   # not one layer
    ("mixtral-8x7b", 1.0, 90.0, None),
])
def test_the_cut_keeps_the_most_layers_that_fit(arch, per_layer, fixed, want):
    cfg = get_arch(arch)
    got, decided = fit.cut(cfg, _fake_reckon(per_layer, fixed), 1)
    if want is None:
        assert got is None and decided.layers == 1 and not decided.fits()
        return
    assert got.n_layers == decided.layers == want and decided.fits()
    if want < cfg.n_layers:                 # one more period, or layer, does not fit
        step = fit.period(cfg) if want >= fit.period(cfg) else 1
        assert not _fake_reckon(per_layer, fixed)(with_layers(cfg, want + step), 1).fits()


def test_the_plan_cuts_at_the_smallest_batch_then_takes_the_largest_that_fits():
    cfg = get_arch("qwen3-1.7b")
    run, decided = fit.plan(cfg, _fake_reckon(3.0, 0.0, 2.5))       # 84 + 2.5 B GB
    assert run is decided and (run.layers, run.batch) == (27, 1)
    run, _ = fit.plan(cfg, _fake_reckon(1.0, 0.0, 5.0))             # 28 + 5 B GB
    assert (run.layers, run.batch) == (28, 8)
    run, _ = fit.plan(cfg, _fake_reckon(1.0, 0.0, 10.0))
    assert (run.layers, run.batch) == (28, 4)


def test_phi35_moe_serves_32k_cut_where_its_weights_alone_fit():
    """Its weights (83.75 GB) fit 85 GB alone, so the former rule, which cut
    only where the weights did not, refused the pair; the plan now cuts it
    to the most layers that fit at batch 1."""
    full = get_arch("phi3.5-moe-42b-a6.6b")
    assert fit.nbytes(fit.meta_params(full)) < fit.CARD_BYTES
    cfg, run, decided = fit.serve_plan(full.name, "serve_32k")
    assert run is decided and run.fits() and run.batch == 1
    assert 0 < run.layers < full.n_layers == 32 and cfg.n_layers == run.layers
    assert not fit.serve_reckoning(with_layers(full, run.layers + 1), 1, 32768).fits()


@pytest.mark.parametrize("arch", ["pixtral-12b", "jamba-v0.1-52b", "phi3.5-moe-42b-a6.6b"])
def test_train_4k_is_cut_to_fit_where_the_whole_model_does_not(arch):
    """At 10 B a parameter (bf16 weights, fp32 moments) these do not train
    whole on one card at batch 1; the plan cuts them and they fit.  Jamba,
    of which not one period of 8 layers fits, keeps the longest prefix of
    one, and its line names the kinds it keeps."""
    full = get_arch(arch)
    assert not fit.train_reckoning(full, 1, 4096).fits()
    cfg, run, decided = fit.train_plan(arch)
    assert run is not None and run.fits() and 0 < run.layers < full.n_layers
    if arch == "jamba-v0.1-52b":
        assert run.layers < fit.period(full) == 8
        assert run.kinds == tuple(k.value for k in full.block_kinds()[:run.layers])
        assert ", ".join(run.kinds) in run.line()
        assert not fit.train_reckoning(with_layers(full, 8), 1, 4096).fits()
    else:
        assert not run.kinds


def test_seamless_and_pixtral_are_reckoned_on_the_specs_inputs():
    """A reckoning builds its batch from ``launch.dryrun.input_specs``:
    pixtral's ``embeds`` (B, S, 5120) in place of tokens, seamless's tokens
    beside ``enc_embeds`` (B, 1500, 1024), and a training step's labels.
    Seamless's serving state holds its cross K/V buffers and valid mask, and
    a plan line of seamless names its encoder's layers."""
    pix, sea = get_arch("pixtral-12b"), get_arch("seamless-m4t-large-v2")
    got = fit.step_inputs(pix, 2, 64)
    assert set(got) == {"embeds"} and tuple(got["embeds"].shape) == (2, 64, 5120)
    got = fit.step_inputs(sea, 2, 64, train=True)
    assert set(got) == {"tokens", "enc_embeds", "labels"}
    assert tuple(got["enc_embeds"].shape) == (2, 1500, 1024)
    cfg = dataclasses.replace(reduced(sea), dtype="bfloat16")
    params = TT.init_params(cfg, torch.Generator().manual_seed(0))
    rec = fit.serve_reckoning(cfg, 2, 24, new_tokens=8)
    frames = cfg.encdec.max_source_positions
    cross = TT.init_cross_caches(params, cfg, 2, frames)
    assert rec.state == fit.nbytes(TT.init_caches(params, cfg, 2, 32)) + fit.nbytes(cross)
    assert fit.nbytes(cross) > 0 and rec.enc_layers == cfg.encdec.encoder_layers
    assert f"{cfg.n_layers} decoder and {cfg.encdec.encoder_layers} encoder layers" in rec.line()
    rec = fit.train_reckoning(dataclasses.replace(reduced(pix), dtype="bfloat16"), 2, 24)
    assert rec.step > 0
