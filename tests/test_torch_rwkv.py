"""The port's RWKV6 path against the JAX package on the CPU: the plain wkv
recurrence against ``repro.kernels.ref.rwkv6_scan_ref`` and the Pallas
``rwkv6_scan`` (``interpret=True``); the modules of ``models/rwkv.py``;
reduced ``rwkv6-1.6b`` (attention-free, no KV cache) through the
transformer and the serving engine; and the device dispatch of
``kernels.ops.rwkv6_scan``.

Inputs and weights come from numpy seeds and are handed to both packages.
Tolerances: the recurrence at 2e-4, as ``tests/test_kernels.py`` holds it;
layers and models at float32, atol = rtol = 1e-4, as
``tests/test_models.py``: the JAX model scans in chunks with an associative
scan, the port in one sequential loop, so the sums run in different
orders."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.config import reduced as jax_reduced  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rwkv6_scan import rwkv6_scan as pallas_rwkv6_scan  # noqa: E402
from repro.models import rwkv as jrk  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import PagedKVManager as JaxKV  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.train.checkpoint import _flatten  # noqa: E402
from repro_torch.config import BlockKind, get_arch, reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rwkv6_scan as tkernel  # noqa: E402
from repro_torch.models import rwkv as trk  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import PagedKVManager, ServingEngine  # noqa: E402

ARCH = "rwkv6-1.6b"
SCAN_TOL = dict(atol=2e-4, rtol=2e-4)
TOL = dict(atol=1e-4, rtol=1e-4)
KERNEL_SHAPES = [   # B, T, H, hd, block_t (tests/test_kernels.py)
    (2, 128, 2, 64, 32), (1, 64, 4, 32, 64), (2, 96, 1, 16, 48),
]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(t, j, **tol):
    np.testing.assert_allclose(_f32(t), _f32(j), **(tol or TOL))


def _wkv_inputs(B, T, H, hd, seed=0):
    """r, k, v, w, u and a state in numpy, at the scales of
    ``tests/test_kernels.py``."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    k = (rng.standard_normal((B, T, H, hd)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((B, T, H, hd)) * 0.3).astype(np.float32)
    w = (1 / (1 + np.exp(-(rng.standard_normal((B, T, H, hd)) * 0.5 + 2)))).astype(np.float32)
    u = (rng.standard_normal((H, hd)) * 0.1).astype(np.float32)
    S0 = (rng.standard_normal((B, H, hd, hd)) * 0.3).astype(np.float32)
    return r, k, v, w, u, S0


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _cfgs(**kw):
    """The same reduced RWKV6 at float32 in both packages."""
    j = dataclasses.replace(jax_reduced(jax_get_arch(ARCH), **kw), dtype="float32")
    t = dataclasses.replace(reduced(get_arch(ARCH), **kw), dtype="float32")
    return j, t


def _models(seed, **kw):
    jcfg, tcfg = _cfgs(**kw)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jparams, params_from_jax(_flatten(jparams), device="cpu")


def _block_params(jcfg, seed=0):
    """One RWKV6 block's weights in both packages, with the mixing factors,
    the decay base and the norm scale drawn at random so that each is
    exercised."""
    jp = jrk.rwkv_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    rng = np.random.default_rng(seed)
    d = jcfg.d_model
    for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "cm_mu_k", "cm_mu_r"):
        jp[name] = jnp.asarray(rng.uniform(0.0, 1.0, d), jnp.float32)
    jp["decay_base"] = jnp.asarray(rng.uniform(-7.0, -1.0, d), jnp.float32)
    jp["ln_x"] = jnp.asarray(rng.uniform(0.5, 1.5, d), jnp.float32)
    return jp, params_from_jax(_flatten(jp), device="cpu")


# ---------------------------------------------------------------------------
# the plain recurrence


@pytest.mark.parametrize("B,T,H,hd,bt", KERNEL_SHAPES)
def test_rwkv6_scan_plain_matches_jax_oracle_and_pallas(B, T, H, hd, bt):
    r, k, v, w, u, _ = _wkv_inputs(B, T, H, hd)
    o, S = tref.rwkv6_scan_ref(*_torch(r, k, v, w, u))
    assert o.dtype == torch.float32 and o.shape == (B, T, H, hd) and S.shape == (B, H, hd, hd)
    jargs = [jnp.asarray(a) for a in (r, k, v, w, u)]
    orf, Sr = jref.rwkv6_scan_ref(*jargs)
    op, Sp = pallas_rwkv6_scan(*jargs, block_t=bt, interpret=True)
    for out, expect in ((o, orf), (S, Sr), (o, op), (S, Sp)):
        _close(out, expect, **SCAN_TOL)


@pytest.mark.parametrize("B,T,H,hd", [
    (2, 150, 2, 32),        # T not a multiple of any block
    (3, 1, 4, 64),          # one step, as at decode
    (1, 33, 1, 16),
])
def test_rwkv6_scan_plain_from_a_state_matches_jax_oracle(B, T, H, hd):
    r, k, v, w, u, S0 = _wkv_inputs(B, T, H, hd, seed=T)
    o, S = tref.rwkv6_scan_ref(*_torch(r, k, v, w, u, S0))
    orf, Sr = jref.rwkv6_scan_ref(*(jnp.asarray(a) for a in (r, k, v, w, u, S0)))
    _close(o, orf, **SCAN_TOL)
    _close(S, Sr, **SCAN_TOL)


def test_rwkv6_scan_plain_splits_at_any_step():
    """Two recurrences chained through the state equal one over both."""
    r, k, v, w, u, S0 = _torch(*_wkv_inputs(2, 29, 2, 16, seed=3))
    o, S = tref.rwkv6_scan_ref(r, k, v, w, u, S0)
    o1, S1 = tref.rwkv6_scan_ref(r[:, :11], k[:, :11], v[:, :11], w[:, :11], u, S0)
    o2, S2 = tref.rwkv6_scan_ref(r[:, 11:], k[:, 11:], v[:, 11:], w[:, 11:], u, S1)
    torch.testing.assert_close(torch.cat([o1, o2], dim=1), o, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(S2, S, atol=1e-6, rtol=1e-6)


def test_rwkv6_scan_plain_rounds_bf16_once():
    r, k, v, w, u, S0 = _torch(*_wkv_inputs(2, 7, 2, 16, seed=4))
    args = [t.to(torch.bfloat16) for t in (r, k, v, w, u)]
    o, S = tref.rwkv6_scan_ref(*args, S0)
    o32, S32 = tref.rwkv6_scan_ref(*(t.float() for t in args), S0)
    assert o.dtype == torch.bfloat16 and S.dtype == torch.float32
    assert torch.equal(o, o32.to(torch.bfloat16)) and torch.equal(S, S32)


# ---------------------------------------------------------------------------
# the op's dispatch and the kernel wrapper's checks


def test_cpu_tensors_take_the_plain_version_and_do_not_count():
    args = _torch(*_wkv_inputs(2, 9, 2, 16, seed=5))
    ops.reset_launches()
    o, S = ops.rwkv6_scan(*args)
    orf, Sr = tref.rwkv6_scan_ref(*args)
    assert torch.equal(o, orf) and torch.equal(S, Sr)
    assert sum(ops.LAUNCHES.values()) == 0


def test_an_empty_recurrence_keeps_the_state():
    r, k, v, w, u, S0 = _torch(*_wkv_inputs(2, 0, 2, 16))
    ops.reset_launches()
    o, S = ops.rwkv6_scan(r, k, v, w, u, S0)
    assert o.shape == (2, 0, 2, 16) and torch.equal(S, S0)
    assert ops.LAUNCHES["rwkv6_scan"] == 0


def test_other_devices_raise():
    args = [t.to("meta") for t in _torch(*_wkv_inputs(1, 4, 2, 16))]
    with pytest.raises(ValueError, match="no implementation"):
        ops.rwkv6_scan(*args)


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        tkernel.rwkv6_scan(*_torch(*_wkv_inputs(1, 4, 2, 16)))


@pytest.mark.parametrize("case", ["k", "v", "u", "head_size", "S0_shape", "S0_dtype"])
def test_check_inputs_rejects(case):
    r, k, v, w, u, S0 = _torch(*_wkv_inputs(2, 5, 2, 16))
    if case == "k":
        k = k[:, :4]
    elif case == "v":
        v = v.reshape(2, 5, 1, 32)
    elif case == "u":
        u = u[:1]
    elif case == "head_size":
        r, k, v, w, u, S0 = _torch(*_wkv_inputs(2, 5, 2, 48))
    elif case == "S0_shape":
        S0 = S0[:, :1]
    else:
        S0 = S0.half()
    with pytest.raises(ValueError, match="rwkv6_scan"):
        tkernel.check_inputs(r, k, v, w, u, S0)


# ---------------------------------------------------------------------------
# the modules of models/rwkv.py


def test_wkv_terms_match_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _block_params(jcfg, seed=6)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, jcfg.d_model)).astype(np.float32)
    xs = rng.standard_normal((2, 9, jcfg.d_model)).astype(np.float32)
    got = trk._wkv_terms(tp, torch.from_numpy(x), torch.from_numpy(xs), tcfg)
    for t, j in zip(got, jrk._wkv_terms(jp, jnp.asarray(x), jnp.asarray(xs), jcfg)):
        assert tuple(t.shape) == j.shape
        _close(t, j)


@pytest.mark.parametrize("S", [1, 16, 64])
def test_time_mix_then_decode_steps_match_jax(S):
    """The sequence path from no state, then three one-token steps from the
    state it returns: outputs and both parts of the state."""
    jcfg, tcfg = _cfgs()
    jp, tp = _block_params(jcfg, seed=7)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    ty, tst = trk.rwkv_time_mix(tp, torch.from_numpy(x), tcfg)
    jy, jst = jrk.rwkv_time_mix(jp, jnp.asarray(x), jcfg, None, 64)
    _close(ty, jy)
    for _ in range(3):
        _close(tst["wkv"], jst["wkv"])
        _close(tst["shift_tm"], jst["shift_tm"])
        xt = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        ty, tst = trk.rwkv_time_mix(tp, torch.from_numpy(xt), tcfg, tst)
        jy, jst = jrk.rwkv_time_mix(jp, jnp.asarray(xt), jcfg, jst, 64)
        _close(ty, jy)


@pytest.mark.parametrize("with_state", [False, True])
def test_channel_mix_matches_jax(with_state):
    jcfg, _ = _cfgs()
    jp, tp = _block_params(jcfg, seed=8)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 7, jcfg.d_model)).astype(np.float32)
    st = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32) if with_state else None
    ty, tnew = trk.rwkv_channel_mix(tp, torch.from_numpy(x),
                                    None if st is None else torch.from_numpy(st))
    jy, jnew = jrk.rwkv_channel_mix(jp, jnp.asarray(x), None if st is None else jnp.asarray(st))
    _close(ty, jy)
    _close(tnew, jnew)


def test_rwkv_init_state_matches_jax():
    jcfg, tcfg = _cfgs()
    t = trk.rwkv_init_state(tcfg, 3, torch.float32)
    j = jrk.rwkv_init_state(jcfg, 3, jnp.float32)
    assert {k: tuple(v.shape) for k, v in t.items()} == {k: v.shape for k, v in j.items()}


def test_bf16_block_keeps_decay_and_bonus_in_fp32():
    _, tcfg = _cfgs(d_model=128)
    p = trk.rwkv_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16, (2,))
    assert p["decay_base"].dtype == torch.float32 and p["bonus_u"].dtype == torch.float32
    assert p["wr"].dtype == torch.bfloat16 and p["bonus_u"].shape == (2, 2, 64)
    x = torch.randn((2, 5, 128), generator=torch.Generator().manual_seed(1)).bfloat16()
    one = {k: v[0] for k, v in p.items()}
    y, st = trk.rwkv_time_mix(one, x, tcfg)
    assert y.dtype == torch.bfloat16 and st["wkv"].dtype == torch.float32
    assert bool(y.float().isfinite().all())


# ---------------------------------------------------------------------------
# the stack


def test_config_and_block_kinds_match_jax():
    j, t = jax_get_arch(ARCH), get_arch(ARCH)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    jc, tc = _cfgs()
    assert jc.block_kinds() == tuple(k.value for k in tc.block_kinds())
    assert set(tc.block_kinds()) == {BlockKind.RWKV} and tc.is_attention_free


def test_init_params_tree_matches_jax_shapes():
    jcfg, tcfg = _cfgs()
    jflat = _flatten(JT.init_params(jcfg, jax.random.PRNGKey(0)))
    tflat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}/")
        elif isinstance(node, tuple):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}/")
        else:
            tflat[prefix[:-1]] = (tuple(node.shape), str(node.dtype).split(".")[-1])

    walk(TT.init_params(tcfg, torch.Generator().manual_seed(0)), "")
    assert tflat == {k: (tuple(v.shape), v.dtype.name) for k, v in jflat.items()}
    assert "blocks/0/mlp/w_gate" not in tflat and "blocks/0/rwkv/cm_wk" in tflat


def test_forward_logits_match_jax():
    jcfg, tcfg, jparams, tparams = _models(9)
    toks = np.random.default_rng(9).integers(0, jcfg.vocab_size, (2, 64))
    jl, _ = JT.forward(jparams, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, aux = TT.forward(tparams, tcfg, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)
    assert float(aux) == 0.0


@pytest.mark.parametrize("n_layers,B,S", [(2, 2, 64), (2, 3, 13), (4, 2, 1)])
def test_prefill_and_decode_logits_match_jax(n_layers, B, S):
    """Prefill, then 4 decode steps: logits and every state at the end."""
    jcfg, tcfg, jparams, tparams = _models(10, n_layers=n_layers)
    toks = np.random.default_rng(10).integers(0, jcfg.vocab_size, (B, S + 4))
    jl, jc = JT.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks[:, :S], jnp.int32)},
                        seq_len=S + 8)
    tl, tc = TT.prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks[:, :S])},
                        seq_len=S + 8)
    _close(tl, jl)
    for i in range(4):
        nxt = toks[:, S + i:S + i + 1]
        jl, jc = JT.decode_step(jparams, jcfg, jnp.asarray(nxt, jnp.int32),
                                jnp.int32(S + i), jc)
        tl, tc = TT.decode_step(tparams, tcfg, torch.from_numpy(nxt), S + i, tc)
        _close(tl, jl)
    (tcache,), (jcache,) = tc["layers"], jc["layers"]
    assert tcache.keys() == jcache.keys()
    for k in tcache:
        _close(tcache[k], jcache[k])


def test_decode_writes_the_states_in_place():
    """The caches prefill returns are the tensors decode steps update: the
    wkv state and both token shifts move at every step."""
    _, tcfg, _, tparams = _models(11)
    toks = np.random.default_rng(11).integers(0, tcfg.vocab_size, (2, 12))
    _, caches = TT.prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks[:, :8])},
                           seq_len=16)
    (view,) = caches["layers"]
    assert set(view) == {"wkv", "shift_tm", "shift_cm"}
    for i in range(3):
        before = {k: v.clone() for k, v in view.items()}
        _, out = TT.decode_step(tparams, tcfg, torch.from_numpy(toks[:, 8 + i:9 + i]),
                                8 + i, caches)
        assert out["layers"][0] is view
        for k in view:
            assert not torch.equal(view[k], before[k]), k


def test_prefill_of_any_length_continues_the_full_sequence():
    """The port scans any T: a 150-token prefill gives the last logits of the
    full forward pass, and a decode step after 149 tokens gives its logits
    at the 150th (JAX's chunked scan takes T <= 64 or a multiple of 64)."""
    _, tcfg, _, tparams = _models(12)
    toks = torch.from_numpy(np.random.default_rng(12).integers(0, tcfg.vocab_size, (2, 150)))
    full, _ = TT.forward(tparams, tcfg, {"tokens": toks})
    last, _ = TT.prefill(tparams, tcfg, {"tokens": toks}, seq_len=160)
    torch.testing.assert_close(last[:, 0], full[:, -1], **TOL)
    _, caches = TT.prefill(tparams, tcfg, {"tokens": toks[:, :149]}, seq_len=160)
    step, _ = TT.decode_step(tparams, tcfg, toks[:, 149:], 149, caches)
    torch.testing.assert_close(step[:, 0], full[:, -1], **TOL)


@pytest.mark.parametrize("full_width", [False, True])
def test_kv_manager_of_an_attention_free_model_matches_jax(full_width):
    jcfg, tcfg = (jax_get_arch(ARCH), get_arch(ARCH)) if full_width else _cfgs()
    t, j = PagedKVManager(tcfg, 4, 64), JaxKV(jcfg, 4, 64)
    assert (t.pages_per_slot, t.total_pages, t.bytes_per_slot()) == \
        (j.pages_per_slot, j.total_pages, j.bytes_per_slot()) == (1, 4, 0)


@pytest.mark.parametrize("B", [2, 4])
def test_engine_greedy_tokens_match_jax(B):
    jcfg, tcfg = _cfgs()
    jeng = JaxEngine(jcfg, batch_slots=B, max_seq_len=32, seed=3)
    params = params_from_jax(_flatten(jeng.params), device="cpu")
    teng = ServingEngine(tcfg, batch_slots=B, max_seq_len=32, device="cpu", params=params)
    prompts = np.random.default_rng(B).integers(0, jcfg.vocab_size, (B, 5)).tolist()
    ops.reset_launches()
    assert teng.generate(prompts, max_new_tokens=6) == jeng.generate(prompts, max_new_tokens=6)
    assert sum(ops.LAUNCHES.values()) == 0


def test_launcher_serves_rwkv6_on_junctiond(capsys):
    from repro_torch.launch import serve
    summary = serve.main(["--arch", ARCH, "--device", "cpu", "--backend", "junctiond",
                          "--requests", "5", "--batch-slots", "2", "--max-new-tokens", "3"])
    out = capsys.readouterr().out
    assert f"deploying {ARCH}" in out and "behind junctiond" in out
    assert "5 invocations through the junctiond runtime (simulated): median=" in out
    assert summary.n == 5 and summary.median_ms <= summary.p99_ms
