"""The port's layers, attention and transformer against the JAX model on
the CPU, at float32, with the same weights carried across by
``params_from_jax``.  Tolerance atol/rtol 1e-4: the two frameworks sum in
different orders."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.config import reduced as jax_reduced  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train.checkpoint import _flatten  # noqa: E402
from repro_torch.config import (ArchType, EncDecConfig, MambaConfig,  # noqa: E402
                                MoEConfig, get_arch, reduced)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(tol or TOL))


def _cfgs(**kw):
    """The same reduced qwen3-1.7b at float32 in both packages."""
    j = dataclasses.replace(jax_reduced(jax_get_arch("qwen3-1.7b")), dtype="float32", **kw)
    t = dataclasses.replace(reduced(get_arch("qwen3-1.7b")), dtype="float32", **kw)
    return j, t


def _attn_params(jcfg, seed=0):
    jp = jattn.attn_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    # random qk-norm weights so that the norm's weight is exercised too
    rng = np.random.default_rng(seed)
    hd = jcfg.resolved_head_dim
    jp["q_norm"] = jnp.asarray(rng.uniform(0.5, 1.5, hd), jnp.float32)
    jp["k_norm"] = jnp.asarray(rng.uniform(0.5, 1.5, hd), jnp.float32)
    return jp, params_from_jax(_flatten(jp), device="cpu")


# ---------------------------------------------------------------------------
def test_config_matches_jax():
    j, t = jax_get_arch("qwen3-1.7b"), get_arch("qwen3-1.7b")
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.block_kinds() == tuple(k.value for k in t.block_kinds())


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    _close(tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 60, (2, 7))
    _close(tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32), theta))


def test_swiglu_matches_jax():
    rng = np.random.default_rng(2)
    p = {n: rng.standard_normal(s).astype(np.float32) * 0.1 for n, s in
         (("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32)))}
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    _close(tlayers.swiglu({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x)),
           jlayers.swiglu({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))


@pytest.mark.parametrize("q_len,kv_len,window,q_offset", [
    (6, 6, None, 0), (6, 6, 2, 0), (2, 6, None, 4), (5, 9, 3, 4),
])
def test_causal_mask_matches_jax(q_len, kv_len, window, q_offset):
    t = tlayers.causal_mask(q_len, kv_len, window=window, q_offset=q_offset)
    j = jlayers.causal_mask(q_len, kv_len, window=window, q_offset=q_offset)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_kv_heads,window,S,seq_len", [
    (4, None, 12, 20),      # full cache, G = 1
    (2, None, 12, 20),      # G = 2, as at full width
    (2, 8, 12, 20),         # sliding window, capacity 8 < prompt: the ring wraps
    (4, 5, 13, 20),         # ring wraps with a shift that is not 0
])
def test_prefill_and_decode_attention_match_jax(n_kv_heads, window, S, seq_len):
    jcfg, tcfg = _cfgs(n_kv_heads=n_kv_heads, sliding_window=window)
    jp, tp = _attn_params(jcfg)
    rng = np.random.default_rng(3)
    B, d = 2, jcfg.d_model
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))

    jcache = jattn.init_kv_cache(jcfg, B, seq_len, jnp.float32)
    tcache = tattn.init_kv_cache(tcfg, B, seq_len, torch.float32, "cpu")
    assert tcache["k"].shape == jcache["k"].shape
    jy, jcache = jattn.prefill_into_cache(jp, jnp.asarray(x), jcfg,
                                          jnp.asarray(pos, jnp.int32), jcache)
    ty, tcache = tattn.prefill_into_cache(tp, torch.from_numpy(x), tcfg,
                                          torch.from_numpy(pos.copy()), tcache)
    _close(ty, jy)
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])

    for step in range(seq_len - S):
        xt = rng.standard_normal((B, 1, d)).astype(np.float32)
        p = S + step
        jy, jcache = jattn.decode_step_attention(jp, jnp.asarray(xt), jcfg,
                                                 jnp.int32(p), jcache)
        step_in = tattn.decode_step_inputs(tcfg, p, B, tcache["k"].shape[1], "cpu")
        ty, tcache = tattn.decode_step_attention(tp, torch.from_numpy(xt), tcfg,
                                                 step_in, tcache)
        _close(ty, jy)
    _close(tcache["k"], jcache["k"])


def test_attention_forward_matches_jax():
    jcfg, tcfg = _cfgs(n_kv_heads=2)
    jp, tp = _attn_params(jcfg, seed=4)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 10, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(10), (2, 10))
    _close(tattn.attention_forward(tp, torch.from_numpy(x), tcfg,
                                   torch.from_numpy(pos.copy())),
           jattn.attention_forward(jp, jnp.asarray(x), jcfg, jnp.asarray(pos)))


def test_gqa_attend_matches_jax():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 6, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 9, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 9, 2, 32)).astype(np.float32)
    tm = tlayers.causal_mask(6, 9, q_offset=3)
    jm = jlayers.causal_mask(6, 9, q_offset=3)
    _close(tattn.gqa_attend(*map(torch.from_numpy, (q, k, v)), tm),
           jattn.gqa_attend(*map(jnp.asarray, (q, k, v)), jm))


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_kv_heads", [None, 2])
def test_transformer_prefill_decode_logits_match_jax(n_kv_heads):
    kw = {} if n_kv_heads is None else {"n_kv_heads": n_kv_heads}
    jcfg, tcfg = _cfgs(**kw)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(7))
    tparams = params_from_jax(_flatten(jparams), device="cpu")
    rng = np.random.default_rng(7)
    B, S, seq_len = 2, 9, 16
    toks = rng.integers(0, jcfg.vocab_size, (B, S + 3))

    jl, jc = JT.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks[:, :S], jnp.int32)},
                        seq_len=seq_len)
    tl, tc = TT.prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks[:, :S])},
                        seq_len=seq_len)
    _close(tl, jl)
    for i in range(3):
        nxt = toks[:, S + i:S + i + 1]
        jl, jc = JT.decode_step(jparams, jcfg, jnp.asarray(nxt, jnp.int32),
                                jnp.int32(S + i), jc)
        tl, tc = TT.decode_step(tparams, tcfg, torch.from_numpy(nxt), S + i, tc)
        _close(tl, jl)
    _close(tc["layers"][0]["k"], jc["layers"][0]["k"])


def test_transformer_forward_matches_jax():
    jcfg, tcfg = _cfgs(n_kv_heads=2)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(8))
    tparams = params_from_jax(_flatten(jparams), device="cpu")
    toks = np.random.default_rng(8).integers(0, jcfg.vocab_size, (2, 11))
    jl, _ = JT.forward(jparams, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, aux = TT.forward(tparams, tcfg, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)
    assert float(aux) == 0.0


def test_params_from_jax_keeps_tree_and_bf16():
    jcfg, _ = _cfgs()
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(9))
    flat = _flatten(jparams)
    tparams = params_from_jax(flat, device="cpu")
    assert isinstance(tparams["blocks"], tuple) and len(tparams["blocks"]) == 1
    wq = tparams["blocks"][0]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    assert tuple(wq.shape) == flat["blocks/0/attn/wq"].shape
    np.testing.assert_array_equal(wq.float().numpy(),
                                  np.asarray(flat["blocks/0/attn/wq"], np.float32))


def test_init_params_tree_matches_jax_shapes():
    jcfg, tcfg = _cfgs()
    jflat = _flatten(JT.init_params(jcfg, jax.random.PRNGKey(0)))
    tparams = TT.init_params(tcfg, torch.Generator().manual_seed(0))
    tflat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}/")
        elif isinstance(node, tuple):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}/")
        else:
            tflat[prefix[:-1]] = tuple(node.shape)

    walk(tparams, "")
    assert tflat == {k: tuple(v.shape) for k, v in jflat.items()}


@pytest.mark.parametrize("change,item", [
    (dict(moe=MoEConfig(num_experts=4)), "item 9"),
    (dict(arch_type=ArchType.HYBRID, attn_every=2, mamba=MambaConfig()), "item 10"),
    (dict(arch_type=ArchType.SSM), "item 11"),
    (dict(encdec=EncDecConfig(encoder_layers=2)), "item 12"),
])
def test_unported_block_kinds_raise(change, item):
    _, tcfg = _cfgs()
    tcfg = dataclasses.replace(tcfg, **change)
    with pytest.raises(NotImplementedError, match=item):
        TT.init_params(tcfg, torch.Generator().manual_seed(0))
