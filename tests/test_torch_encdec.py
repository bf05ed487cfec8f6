"""The encoder-decoder (seamless-m4t-large-v2) and stub-frontend (pixtral-12b)
models of the port against the JAX model on the CPU.

Everything runs at float32 with JAX's weights carried across by
``params_from_jax``, on numpy inputs from a seed that both packages are
handed (the frontends' random draws cannot match across frameworks, so the
tests feed both the same embeddings).  Tolerance atol/rtol 1e-4, as in
``tests/test_torch_models.py``: the two frameworks sum in different
orders.  The encoder's attention goes through ``ops.flash_attention``
(non-causal), whose plain version is also held against the Pallas kernel
in interpret mode; cross-attention takes ``gqa_attend`` on the CPU, as the
JAX model does.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.config import reduced as jax_reduced  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import frontends as jfront  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.train.checkpoint import _flatten  # noqa: E402
from repro_torch.config import FrontendStub, get_arch, reduced  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import frontends as tfront  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
SEAMLESS, PIXTRAL = "seamless-m4t-large-v2", "pixtral-12b"


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               **(tol or TOL))


def _cfgs(name, **kw):
    """The same reduced config at float32 in both packages; a ``frontend``
    override is given as (kind, num_tokens, embed_dim)."""
    fe = kw.pop("frontend", None)
    j = dataclasses.replace(jax_reduced(jax_get_arch(name)), dtype="float32", **kw)
    t = dataclasses.replace(reduced(get_arch(name)), dtype="float32", **kw)
    if fe is not None:
        j = dataclasses.replace(j, frontend=dataclasses.replace(j.frontend, embed_dim=fe))
        t = dataclasses.replace(t, frontend=FrontendStub(t.frontend.kind,
                                                         t.frontend.num_tokens, fe))
    return j, t


def _models(name, seed, **kw):
    """Configs of both packages, and JAX's weights in both."""
    jcfg, tcfg = _cfgs(name, **kw)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, params_from_jax(_flatten(jp), device="cpu")


def _flat_shapes(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat_shapes(v, f"{prefix}{k}/"))
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            out.update(_flat_shapes(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tuple(tree.shape)
    return out


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _prefix_mask(B, T, lengths):
    return np.arange(T)[None, :] < np.asarray(lengths)[:, None]


# ---------------------------------------------------------------------------
# configs, frontends, parameters


@pytest.mark.parametrize("name", [SEAMLESS, PIXTRAL])
def test_config_matches_jax(name):
    j, t = jax_get_arch(name), get_arch(name)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.block_kinds() == tuple(k.value for k in t.block_kinds())
    assert tfront.frontend_token_count(t) == jfront.frontend_token_count(j)
    jr, tr = jax_reduced(j), reduced(t)
    assert dataclasses.asdict(jr) == dataclasses.asdict(tr)


def test_stub_frontend_embeddings():
    cfg = reduced(get_arch(PIXTRAL))              # bf16, 16 patches of d_model
    draw = [tfront.stub_frontend_embeddings(cfg, torch.Generator().manual_seed(5), 2)
            for _ in range(2)]
    assert draw[0].shape == (2, 16, cfg.d_model) and draw[0].dtype == torch.bfloat16
    assert torch.equal(draw[0], draw[1])
    assert tfront.stub_frontend_embeddings(cfg, torch.Generator(), 3, num_tokens=7).shape == \
        (3, 7, cfg.d_model)
    assert tfront.frontend_token_count(get_arch("qwen3-1.7b")) == 0
    with pytest.raises(ValueError, match="no frontend"):
        tfront.stub_frontend_embeddings(get_arch("qwen3-1.7b"), torch.Generator(), 1)


@pytest.mark.parametrize("name,embed_dim", [
    (SEAMLESS, None), (PIXTRAL, None),
    (SEAMLESS, 96),          # frontend width != d_model: frontend_proj exists
])
def test_init_params_tree_matches_jax_shapes(name, embed_dim):
    kw = {} if embed_dim is None else {"frontend": embed_dim}
    jcfg, tcfg = _cfgs(name, **kw)
    jflat = _flatten(JT.init_params(jcfg, jax.random.PRNGKey(0)))
    tflat = _flat_shapes(TT.init_params(tcfg, torch.Generator().manual_seed(0)))
    assert tflat == {k: tuple(v.shape) for k, v in jflat.items()}
    assert ("frontend_proj" in tflat) == (embed_dim is not None)
    assert ("enc_norm" in tflat) == (name == SEAMLESS)


def test_new_parameters_are_drawn_after_the_decoder():
    """A config without an encoder or a frontend projection gets the same
    weights from the same seed as before: the new tensors come last."""
    _, tcfg = _cfgs(SEAMLESS, frontend=96)
    plain = dataclasses.replace(tcfg, encdec=None, frontend=None)
    full = TT.init_params(tcfg, torch.Generator().manual_seed(3))
    dec = TT.init_params(plain, torch.Generator().manual_seed(3))
    assert torch.equal(full["embed"], dec["embed"])
    assert torch.equal(full["blocks"][0]["attn"]["wq"], dec["blocks"][0]["attn"]["wq"])


def test_params_from_jax_carries_the_encdec_keys():
    jcfg, _ = _cfgs(SEAMLESS, frontend=96)
    flat = _flatten(JT.init_params(jcfg, jax.random.PRNGKey(1)))
    tp = params_from_jax(flat, device="cpu")
    assert isinstance(tp["enc_blocks"], tuple) and len(tp["enc_blocks"]) == 1
    for key in ("enc_blocks/0/attn/wq", "enc_blocks/0/mlp/w_down", "enc_norm",
                "frontend_proj", "blocks/0/cross/wk", "blocks/0/ln_cross"):
        node = tp
        for part in key.split("/"):
            node = node[int(part)] if isinstance(node, tuple) else node[part]
        np.testing.assert_array_equal(node.numpy(), flat[key])


# ---------------------------------------------------------------------------
# attention: the encoder's, the cross projection, cross-attention


def _attn_params(jcfg, seed):
    jp = jattn.attn_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    rng = np.random.default_rng(seed)
    hd = jcfg.resolved_head_dim
    if jcfg.qk_norm:      # random qk-norm weights, so that the norm's weight counts
        jp["q_norm"] = jnp.asarray(rng.uniform(0.5, 1.5, hd), jnp.float32)
        jp["k_norm"] = jnp.asarray(rng.uniform(0.5, 1.5, hd), jnp.float32)
    return jp, params_from_jax(_flatten(jp), device="cpu")


@pytest.mark.parametrize("qk_norm", [False, True])
def test_project_kv_for_cross_matches_jax(qk_norm):
    jcfg, tcfg = _cfgs(SEAMLESS, qk_norm=qk_norm)
    jp, tp = _attn_params(jcfg, 11)
    enc = _randn(np.random.default_rng(11), 2, 23, jcfg.d_model)
    tk, tv = tattn.project_kv_for_cross(tp, torch.from_numpy(enc), tcfg)
    jk, jv = jattn.project_kv_for_cross(jp, jnp.asarray(enc), jcfg)
    assert tk.shape == (2, 23, tcfg.n_kv_heads, tcfg.resolved_head_dim)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize("T,n_kv_heads", [(23, None), (37, 2)])
def test_encoder_attention_matches_jax(T, n_kv_heads):
    """The JAX encoder's attention (RoPE, then ``gqa_attend`` with no mask)
    and its flash kernel in interpret mode, non-causal at a ragged T."""
    kw = {} if n_kv_heads is None else {"n_kv_heads": n_kv_heads}
    jcfg, tcfg = _cfgs(SEAMLESS, **kw)
    jp, tp = _attn_params(jcfg, 12)
    x = _randn(np.random.default_rng(12), 2, T, jcfg.d_model)
    pos = np.broadcast_to(np.arange(T), (2, T))
    ty = tattn.encoder_attention(tp, torch.from_numpy(x), tcfg, torch.from_numpy(pos.copy()))
    q, k, v = jattn._project_qkv(jp, jnp.asarray(x), jcfg, jnp.asarray(pos, jnp.int32))
    jy = jattn.gqa_attend(q, k, v, None).reshape(2, T, -1) @ jp["wo"]
    _close(ty, jy)
    pallas = jops.flash_attention(*(a.transpose(0, 2, 1, 3) for a in (q, k, v)),
                                  causal=False, window=None, backend="pallas_interpret")
    _close(ty, pallas.transpose(0, 2, 1, 3).reshape(2, T, -1) @ jp["wo"])


def _jax_cross(p, h, cfg, ck, cv, mask):
    """The JAX decoder block's cross sub-layer (``transformer.py:136-148``)
    after its ``ln_cross``."""
    B, S, _ = h.shape
    q = (h @ p["wq"]).reshape(B, S, cfg.n_heads, cfg.resolved_head_dim)
    if cfg.qk_norm:
        q = jlayers.rms_norm(q, p["q_norm"], cfg.norm_eps)
    m = None if mask is None else jnp.broadcast_to(mask[:, None, :], (B, S, ck.shape[1]))
    return jattn.gqa_attend(q, ck, cv, m).reshape(B, S, -1) @ p["wo"]


@pytest.mark.parametrize("S,mask", [(1, None), (1, "prefix"), (7, None), (7, "prefix"),
                                    (7, "masked_row")])
def test_cross_attention_matches_jax(S, mask):
    jcfg, tcfg = _cfgs(SEAMLESS, qk_norm=True, n_kv_heads=2)
    jp, tp = _attn_params(jcfg, 13)
    rng = np.random.default_rng(13)
    B, T = 3, 29
    h = _randn(rng, B, S, jcfg.d_model)
    enc = _randn(rng, B, T, jcfg.d_model)
    valid = None
    if mask is not None:
        valid = _prefix_mask(B, T, [T, 17, 5])
        if mask == "masked_row":
            valid[1] = False
    jk, jv = jattn.project_kv_for_cross(jp, jnp.asarray(enc), jcfg)
    tk, tv = tattn.project_kv_for_cross(tp, torch.from_numpy(enc), tcfg)
    ty = tattn.cross_attention(tp, torch.from_numpy(h), tcfg, (tk, tv),
                               None if valid is None else torch.from_numpy(valid))
    jy = _jax_cross(jp, jnp.asarray(h), jcfg, jk, jv,
                    None if valid is None else jnp.asarray(valid))
    _close(ty, jy)


@pytest.mark.parametrize("device,S,masked,route", [
    ("cpu", 1, False, "plain"), ("cpu", 7, True, "plain"),
    ("cuda", 1, False, "decode"), ("cuda", 1, True, "decode"),
    ("cuda", 7, False, "flash"), ("cuda", 512, False, "flash"),
])
def test_cross_route(device, S, masked, route):
    """The route does not depend on the encoder mask: the flash wrapper
    picks its masked design from the mask itself."""
    assert tattn.cross_route(device, S) == route


@pytest.mark.parametrize("S", [2, 512])
def test_cross_route_sends_a_masked_prefill_on_the_card_to_flash(S):
    """A key mask over several queries takes the flash kernel on the card,
    never the plain version (this once raised); the wrapper's route then
    gives the mask's design."""
    assert tattn.cross_route("cuda", S) == "flash"
    assert tflash.route(torch.bfloat16, True) == "wgmma_masked"
    assert tflash.route(torch.float32, True) == "masked"


# ---------------------------------------------------------------------------
# the encoder, and the whole models


@pytest.mark.parametrize("embed_dim", [None, 96])
def test_encode_matches_jax(embed_dim):
    kw = {} if embed_dim is None else {"frontend": embed_dim}
    jcfg, tcfg, jp, tp = _models(SEAMLESS, 14, **kw)
    width = embed_dim or jcfg.d_model
    x = _randn(np.random.default_rng(14), 2, 23, width)
    out = TT._encode(tp, tcfg, torch.from_numpy(x))
    assert out.shape == (2, 23, tcfg.d_model)
    _close(out, JT._encode(jp, jcfg, jnp.asarray(x), None))


def _seamless_batch(rng, cfg, B, S, T, mask):
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    enc = _randn(rng, B, T, cfg.frontend.embed_dim)
    valid = None
    if mask is not None:
        valid = _prefix_mask(B, T, [T, T - 6, 4])
        if mask == "masked_row":
            valid[1] = False       # JAX averages over all of T there, and so does the port
    jb = {"tokens": jnp.asarray(toks, jnp.int32), "enc_embeds": jnp.asarray(enc)}
    tb = {"tokens": torch.from_numpy(toks), "enc_embeds": torch.from_numpy(enc)}
    if valid is not None:
        jb["enc_mask"], tb["enc_mask"] = jnp.asarray(valid), torch.from_numpy(valid)
    return jb, tb


@pytest.mark.parametrize("mask", [None, "prefix", "masked_row"])
def test_seamless_forward_prefill_decode_match_jax(mask):
    jcfg, tcfg, jp, tp = _models(SEAMLESS, 15)
    rng = np.random.default_rng(15)
    B, S, T, seq_len = 3, 9, 23, 16
    jb, tb = _seamless_batch(rng, jcfg, B, S, T, mask)
    jl, _ = JT.forward(jp, jcfg, jb)
    tl, aux = TT.forward(tp, tcfg, tb)
    _close(tl, jl)
    assert float(aux) == 0.0

    jl, jc = JT.prefill(jp, jcfg, jb, seq_len=seq_len)
    tl, tc = TT.prefill(tp, tcfg, tb, seq_len=seq_len)
    _close(tl, jl)
    # the port keeps one valid mask, JAX's enc_mask where it has one
    assert set(tc) == {"layers", "cross_kv", "cross_valid"}
    assert set(jc) == {"layers", "cross_kv"} | ({"enc_mask"} if mask is not None else set())
    if mask is not None:
        np.testing.assert_array_equal(tc["cross_valid"].numpy(), np.asarray(jc["enc_mask"]))
    else:
        assert bool(tc["cross_valid"].all()) and tc["cross_valid"].shape == (B, T)
    _close(tc["cross_kv"][0][0], jc["cross_kv"][0][0])
    assert tc["cross_kv"][0][0].shape == (jcfg.n_layers, B, T, jcfg.n_kv_heads,
                                          jcfg.resolved_head_dim)
    for i in range(4):                   # greedy on JAX's logits, fed to both
        nxt = np.array(jnp.argmax(jl, -1)).reshape(B, 1)
        jl, jc = JT.decode_step(jp, jcfg, jnp.asarray(nxt, jnp.int32), jnp.int32(S + i), jc)
        tl, tc = TT.decode_step(tp, tcfg, torch.from_numpy(nxt), S + i, tc)
        _close(tl, jl)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), np.asarray(jnp.argmax(jl, -1)))
    _close(tc["layers"][0]["k"], jc["layers"][0]["k"])


@pytest.mark.parametrize("embed_dim", [None, 96])
def test_pixtral_embeds_then_tokens_match_jax(embed_dim):
    """A prompt of image-patch embeddings through ``forward`` and
    ``prefill``, then decode steps on tokens; at pixtral's 4 query heads a
    kv head."""
    kw = {"n_kv_heads": 1}
    if embed_dim is not None:
        kw["frontend"] = embed_dim
    jcfg, tcfg, jp, tp = _models(PIXTRAL, 16, **kw)
    assert ("frontend_proj" in tp) == (embed_dim is not None)
    rng = np.random.default_rng(16)
    B, S, seq_len = 2, 12, 20
    emb = _randn(rng, B, S, jcfg.frontend.embed_dim)
    jl, _ = JT.forward(jp, jcfg, {"embeds": jnp.asarray(emb)})
    tl, _ = TT.forward(tp, tcfg, {"embeds": torch.from_numpy(emb)})
    _close(tl, jl)
    jl, jc = JT.prefill(jp, jcfg, {"embeds": jnp.asarray(emb)}, seq_len=seq_len)
    tl, tc = TT.prefill(tp, tcfg, {"embeds": torch.from_numpy(emb)}, seq_len=seq_len)
    _close(tl, jl)
    assert set(tc) == {"layers"}
    for i in range(4):
        nxt = np.array(jnp.argmax(jl, -1)).reshape(B, 1)
        jl, jc = JT.decode_step(jp, jcfg, jnp.asarray(nxt, jnp.int32), jnp.int32(S + i), jc)
        tl, tc = TT.decode_step(tp, tcfg, torch.from_numpy(nxt), S + i, tc)
        _close(tl, jl)
    _close(tc["layers"][0]["v"], jc["layers"][0]["v"])


def test_engine_on_reduced_pixtral_matches_jax():
    """Token prompts through the port's engine on the CPU, with the JAX
    engine's weights, give the JAX engine's tokens."""
    jcfg, tcfg = _cfgs(PIXTRAL, n_kv_heads=2)
    jeng = JaxEngine(jcfg, batch_slots=2, max_seq_len=32, seed=3)
    teng = ServingEngine(tcfg, batch_slots=2, max_seq_len=32, device="cpu",
                         params=params_from_jax(_flatten(jeng.params), device="cpu"))
    p = [[1, 2, 3, 4, 5], [9, 8, 7, 6, 5]]
    assert teng.generate(p, max_new_tokens=6) == jeng.generate(p, max_new_tokens=6)
