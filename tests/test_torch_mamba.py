"""The port's Mamba path against the JAX package on the CPU: the plain
selective scan against ``repro.kernels.ref.mamba_scan_ref`` and the Pallas
``mamba_scan`` (``interpret=True``); the modules of ``models/mamba.py``;
reduced ``jamba-v0.1-52b`` (Mamba, MoE and attention blocks interleaved)
through the transformer and the serving engine; and the device dispatch of
``kernels.ops.mamba_scan``.

Inputs and weights come from numpy seeds and are handed to both packages.
Tolerances: the scan at 2e-4, as ``tests/test_kernels.py`` holds it; layers
and models at float32, atol = rtol = 1e-4, as ``tests/test_models.py``: the
JAX model scans in chunks with an associative scan, the port in one
sequential loop, so the sums run in different orders, and ``F.softplus``
differs from JAX's ``logaddexp`` by less than 2e-9 above 20."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.config import reduced as jax_reduced  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.mamba_scan import mamba_scan as pallas_mamba_scan  # noqa: E402
from repro.models import mamba as jmb  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.train.checkpoint import _flatten  # noqa: E402
from repro_torch.config import BlockKind, get_arch, reduced  # noqa: E402
from repro_torch.kernels import mamba_scan as tkernel  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import mamba as tmb  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

ARCH = "jamba-v0.1-52b"
SCAN_TOL = dict(atol=2e-4, rtol=2e-4)
TOL = dict(atol=1e-4, rtol=1e-4)
KERNEL_SHAPES = [   # B, S, di, ds, block_d, block_s (tests/test_kernels.py)
    (2, 128, 64, 16, 32, 64), (1, 256, 128, 8, 128, 128), (2, 64, 32, 4, 32, 32),
]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(t, j, **tol):
    np.testing.assert_allclose(_f32(t), _f32(j), **(tol or TOL))


def _scan_inputs(B, S, di, ds, seed=0):
    """Scan terms in numpy, at the scales of ``tests/test_kernels.py``."""
    rng = np.random.default_rng(seed)
    dt = (np.log1p(np.exp(rng.standard_normal((B, S, di)))) * 0.1).astype(np.float32)
    dtx = (rng.standard_normal((B, S, di)) * 0.1).astype(np.float32)
    Bm = rng.standard_normal((B, S, ds)).astype(np.float32)
    Cm = rng.standard_normal((B, S, ds)).astype(np.float32)
    A = (-np.exp(rng.standard_normal((di, ds)))).astype(np.float32)
    h0 = rng.standard_normal((B, di, ds)).astype(np.float32)
    return dt, dtx, Bm, Cm, A, h0


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _cfgs(**kw):
    """The same reduced Jamba at float32 in both packages; 8 layers keep the
    whole 1:7 group (MAMBA, MAMBA_MOE, ATTN at in-group position 4)."""
    kw = {"n_layers": 8, **kw}
    j = dataclasses.replace(jax_reduced(jax_get_arch(ARCH), **kw), dtype="float32")
    t = dataclasses.replace(reduced(get_arch(ARCH), **kw), dtype="float32")
    return j, t


def _models(seed, **kw):
    jcfg, tcfg = _cfgs(**kw)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jparams, params_from_jax(_flatten(jparams), device="cpu")


def _block_params(jcfg, seed=0):
    """One Mamba block's weights in both packages, with A_log, D, the conv
    bias and the dt bias drawn at random so that each is exercised."""
    jp = jmb.mamba_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    rng = np.random.default_rng(seed)
    di, ds = jp["A_log"].shape
    jp["A_log"] = jnp.asarray(rng.uniform(-1.0, 2.0, (di, ds)), jnp.float32)
    jp["D"] = jnp.asarray(rng.uniform(0.5, 1.5, di), jnp.float32)
    jp["conv_b"] = jnp.asarray(rng.standard_normal(di) * 0.1, jnp.float32)
    jp["dt_proj_b"] = jnp.asarray(rng.uniform(-5.0, -1.0, di), jnp.float32)
    return jp, params_from_jax(_flatten(jp), device="cpu")


# ---------------------------------------------------------------------------
# the plain scan


@pytest.mark.parametrize("B,S,di,ds,bd,bs", KERNEL_SHAPES)
def test_mamba_scan_plain_matches_jax_oracle_and_pallas(B, S, di, ds, bd, bs):
    dt, dtx, Bm, Cm, A, _ = _scan_inputs(B, S, di, ds)
    y, h = tref.mamba_scan_ref(*_torch(dt, dtx, Bm, Cm, A))
    assert y.dtype == torch.float32 and y.shape == (B, S, di) and h.shape == (B, di, ds)
    jargs = [jnp.asarray(a) for a in (dt, dtx, Bm, Cm, A)]
    yr, hr = jref.mamba_scan_ref(*jargs)
    yp, hp = pallas_mamba_scan(*jargs, block_d=bd, block_s=bs, interpret=True)
    for out, expect in ((y, yr), (h, hr), (y, yp), (h, hp)):
        _close(out, expect, **SCAN_TOL)


@pytest.mark.parametrize("B,S,di,ds", [
    (2, 150, 48, 16),       # S not a multiple of any block
    (3, 1, 33, 16),         # one step, as at decode; odd di
    (1, 70, 64, 5),
])
def test_mamba_scan_plain_from_a_state_matches_jax_oracle(B, S, di, ds):
    dt, dtx, Bm, Cm, A, h0 = _scan_inputs(B, S, di, ds, seed=S)
    y, h = tref.mamba_scan_ref(*_torch(dt, dtx, Bm, Cm, A, h0))
    yr, hr = jref.mamba_scan_ref(*(jnp.asarray(a) for a in (dt, dtx, Bm, Cm, A, h0)))
    _close(y, yr, **SCAN_TOL)
    _close(h, hr, **SCAN_TOL)


def test_mamba_scan_plain_splits_at_any_step():
    """Two scans chained through the state equal one scan over both."""
    dt, dtx, Bm, Cm, A, h0 = _torch(*_scan_inputs(2, 37, 24, 16, seed=3))
    y, h = tref.mamba_scan_ref(dt, dtx, Bm, Cm, A, h0)
    y1, h1 = tref.mamba_scan_ref(dt[:, :20], dtx[:, :20], Bm[:, :20], Cm[:, :20], A, h0)
    y2, h2 = tref.mamba_scan_ref(dt[:, 20:], dtx[:, 20:], Bm[:, 20:], Cm[:, 20:], A, h1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(h2, h, atol=1e-6, rtol=1e-6)


def test_mamba_scan_plain_rounds_bf16_once():
    dt, dtx, Bm, Cm, A, h0 = _torch(*_scan_inputs(2, 9, 16, 8, seed=4))
    args = [t.to(torch.bfloat16) for t in (dt, dtx, Bm, Cm, A)]
    y, h = tref.mamba_scan_ref(*args, h0)
    y32, h32 = tref.mamba_scan_ref(*(t.float() for t in args), h0)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    assert torch.equal(y, y32.to(torch.bfloat16)) and torch.equal(h, h32)


# ---------------------------------------------------------------------------
# the op's dispatch and the kernel wrapper's checks


def test_cpu_tensors_take_the_plain_version_and_do_not_count():
    args = _torch(*_scan_inputs(2, 11, 16, 16, seed=5))
    ops.reset_launches()
    y, h = ops.mamba_scan(*args)
    yr, hr = tref.mamba_scan_ref(*args)
    assert torch.equal(y, yr) and torch.equal(h, hr)
    assert sum(ops.LAUNCHES.values()) == 0


def test_an_empty_scan_keeps_the_state():
    dt, dtx, Bm, Cm, A, h0 = _torch(*_scan_inputs(2, 0, 16, 16))
    ops.reset_launches()
    y, h = ops.mamba_scan(dt, dtx, Bm, Cm, A, h0)
    assert y.shape == (2, 0, 16) and torch.equal(h, h0)
    assert ops.LAUNCHES["mamba_scan"] == 0


def test_other_devices_raise():
    args = [t.to("meta") for t in _torch(*_scan_inputs(1, 4, 8, 4))]
    with pytest.raises(ValueError, match="no implementation"):
        ops.mamba_scan(*args)


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        tkernel.mamba_scan(*_torch(*_scan_inputs(1, 4, 8, 4)))


@pytest.mark.parametrize("case", ["dtx", "Bm", "Cm", "A", "ds", "h0_shape", "h0_dtype"])
def test_check_inputs_rejects(case):
    dt, dtx, Bm, Cm, A, h0 = _torch(*_scan_inputs(2, 5, 8, 4))
    if case == "dtx":
        dtx = dtx[:, :4]
    elif case == "Bm":
        Bm = torch.zeros((2, 4, 4))
    elif case == "Cm":
        Cm = torch.zeros((2, 5, 3))
    elif case == "A":
        A = A.T.contiguous()
    elif case == "ds":
        Bm, Cm, A = torch.zeros((2, 5, 17)), torch.zeros((2, 5, 17)), torch.zeros((8, 17))
    elif case == "h0_shape":
        h0 = h0[:1]
    else:
        h0 = h0.double()
    with pytest.raises(ValueError, match="mamba_scan"):
        tkernel.check_inputs(dt, dtx, Bm, Cm, A, h0)


# ---------------------------------------------------------------------------
# the modules of models/mamba.py


@pytest.mark.parametrize("with_state", [False, True])
def test_conv1d_matches_jax(with_state):
    jcfg, _ = _cfgs()
    jp, tp = _block_params(jcfg, seed=6)
    di = jp["conv_b"].shape[0]
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 7, di)).astype(np.float32)
    st = rng.standard_normal((2, 3, di)).astype(np.float32) if with_state else None
    out, new = tmb._conv1d(tp, torch.from_numpy(x), None if st is None else torch.from_numpy(st))
    jout, jnew = jmb._conv1d(jp, jnp.asarray(x), None if st is None else jnp.asarray(st))
    _close(out, jout)
    _close(new, jnew)


def test_ssm_terms_match_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _block_params(jcfg, seed=7)
    di = jp["conv_b"].shape[0]
    xs = np.random.default_rng(7).standard_normal((2, 9, di)).astype(np.float32)
    got = tmb._ssm_terms(tp, torch.from_numpy(xs), tcfg)
    for t, j in zip(got, jmb._ssm_terms(jp, jnp.asarray(xs), jcfg)):
        assert t.is_contiguous()
        _close(t, j)


@pytest.mark.parametrize("S", [1, 16, 64])
def test_mamba_forward_then_decode_steps_match_jax(S):
    """The sequence path from no state, then three one-token steps from the
    state it returns: outputs and both parts of the state."""
    jcfg, tcfg = _cfgs()
    jp, tp = _block_params(jcfg, seed=8)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    ty, tst = tmb.mamba_forward(tp, torch.from_numpy(x), tcfg)
    jy, jst = jmb.mamba_forward(jp, jnp.asarray(x), jcfg, None, 64)
    _close(ty, jy)
    for _ in range(3):
        _close(tst["h"], jst["h"])
        _close(tst["conv"], jst["conv"])
        xt = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        ty, tst = tmb.mamba_forward(tp, torch.from_numpy(xt), tcfg, tst)
        jy, jst = jmb.mamba_decode_step(jp, jnp.asarray(xt), jcfg, jst)
        _close(ty, jy)


def test_mamba_init_state_matches_jax():
    jcfg, tcfg = _cfgs()
    t = tmb.mamba_init_state(tcfg, 3, torch.float32)
    j = jmb.mamba_init_state(jcfg, 3, jnp.float32)
    assert {k: tuple(v.shape) for k, v in t.items()} == {k: v.shape for k, v in j.items()}
    assert t["h"].dtype == torch.float32


def test_bf16_block_keeps_A_log_and_D_in_fp32():
    _, tcfg = _cfgs(d_model=128)
    p = tmb.mamba_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16, (2,))
    assert p["A_log"].dtype == torch.float32 and p["D"].dtype == torch.float32
    assert p["in_proj"].dtype == torch.bfloat16 and p["A_log"].shape[0] == 2
    x = torch.randn((2, 5, 128), generator=torch.Generator().manual_seed(1)).bfloat16()
    one = {k: v[0] for k, v in p.items()}
    y, st = tmb.mamba_forward(one, x, tcfg)
    assert y.dtype == torch.bfloat16 and st["h"].dtype == torch.float32
    assert st["conv"].dtype == torch.bfloat16 and bool(y.float().isfinite().all())


# ---------------------------------------------------------------------------
# the stack


@pytest.mark.parametrize("n_layers", [8, 2])
def test_config_and_block_kinds_match_jax(n_layers):
    j, t = jax_get_arch(ARCH), get_arch(ARCH)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    jc, tc = _cfgs(n_layers=n_layers)
    assert jc.block_kinds() == tuple(k.value for k in tc.block_kinds())
    if n_layers == 8:
        assert tc.block_kinds()[4] == BlockKind.ATTN
        assert set(tc.block_kinds()) == {BlockKind.MAMBA, BlockKind.MAMBA_MOE, BlockKind.ATTN}
    else:
        assert tc.block_kinds() == (BlockKind.MAMBA, BlockKind.ATTN_MOE)


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


def test_forward_logits_and_aux_match_jax():
    jcfg, tcfg, jparams, tparams = _models(9)
    toks = np.random.default_rng(9).integers(0, jcfg.vocab_size, (2, 64))
    jl, ja = JT.forward(jparams, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, ta = TT.forward(tparams, tcfg, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)
    _close(ta, ja)


@pytest.mark.parametrize("n_layers,B,S", [(8, 2, 64), (8, 4, 13), (2, 2, 9)])
def test_prefill_and_decode_logits_match_jax(n_layers, B, S):
    """Prefill, then 4 decode steps: logits and every cache at the end.
    Batch 4 at 4 experts, top 2: decode capacity 2, so decode drops pairs."""
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
    for tcache, jcache in zip(tc["layers"], jc["layers"]):
        assert tcache.keys() == jcache.keys()
        for k in tcache:
            _close(tcache[k], jcache[k])


def test_decode_writes_the_states_in_place():
    """The caches prefill returns are the tensors decode steps update: the
    Mamba state and conv window and the KV cache move at every step."""
    _, tcfg, _, tparams = _models(11)
    toks = np.random.default_rng(11).integers(0, tcfg.vocab_size, (2, 12))
    _, caches = TT.prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks[:, :8])},
                           seq_len=16)
    kinds = tcfg.block_kinds()
    views = [caches["layers"][i] for i in range(len(kinds))]
    for i in range(3):
        before = [{k: v.clone() for k, v in c.items()} for c in views]
        _, out = TT.decode_step(tparams, tcfg, torch.from_numpy(toks[:, 8 + i:9 + i]),
                                8 + i, caches)
        assert out["layers"] is caches["layers"]
        for kind, c, b in zip(kinds, views, before):
            for k in c:
                assert not torch.equal(c[k], b[k]), (kind, k)


def test_prefill_of_any_length_continues_the_full_sequence():
    """The port scans any S: a 150-token prefill gives the last logits of the
    full forward pass, and a decode step after 149 tokens gives its logits
    at the 150th (JAX's chunked scan takes S <= 64 or a multiple of 64).
    The MoE capacity factor is 2, so that no pass drops a pair: capacity
    then covers every pair an expert can get (T of T tokens, top 2 of 4)."""
    _, tcfg, _, tparams = _models(12)
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, capacity_factor=2.0))
    toks = torch.from_numpy(np.random.default_rng(12).integers(0, tcfg.vocab_size, (2, 150)))
    full, _ = TT.forward(tparams, tcfg, {"tokens": toks})
    last, _ = TT.prefill(tparams, tcfg, {"tokens": toks}, seq_len=160)
    torch.testing.assert_close(last[:, 0], full[:, -1], **TOL)
    _, caches = TT.prefill(tparams, tcfg, {"tokens": toks[:, :149]}, seq_len=160)
    step, _ = TT.decode_step(tparams, tcfg, toks[:, 149:], 149, caches)
    torch.testing.assert_close(step[:, 0], full[:, -1], **TOL)


@pytest.mark.parametrize("n_layers,B", [(8, 2), (8, 4), (2, 2)])
def test_engine_greedy_tokens_match_jax(n_layers, B):
    jcfg, tcfg = _cfgs(n_layers=n_layers)
    jeng = JaxEngine(jcfg, batch_slots=B, max_seq_len=32, seed=3)
    params = params_from_jax(_flatten(jeng.params), device="cpu")
    teng = ServingEngine(tcfg, batch_slots=B, max_seq_len=32, device="cpu", params=params)
    prompts = np.random.default_rng(B).integers(0, jcfg.vocab_size, (B, 5)).tolist()
    ops.reset_launches()
    assert teng.generate(prompts, max_new_tokens=6) == jeng.generate(prompts, max_new_tokens=6)
    assert sum(ops.LAUNCHES.values()) == 0


def test_launcher_serves_jamba_on_containerd(capsys):
    from repro_torch.launch import serve
    summary = serve.main(["--arch", ARCH, "--device", "cpu", "--backend", "containerd",
                          "--requests", "5", "--batch-slots", "2", "--max-new-tokens", "3"])
    out = capsys.readouterr().out
    assert f"deploying {ARCH}" in out and "behind containerd" in out
    assert "5 invocations through the containerd runtime (simulated): median=" in out
    assert summary.n == 5 and summary.median_ms <= summary.p99_ms
