"""The port's MoE path against the JAX package on the CPU: the plain expert
matmul against ``repro.kernels.ref.moe_gmm_ref`` and the Pallas ``moe_gmm``
(``interpret=True``); routing, the dense oracle and the capacity dispatches
of ``models/moe.py``; reduced ``mixtral-8x7b`` and ``phi3.5-moe-42b-a6.6b``
through the transformer and the serving engine; and the plain-dense
configurations ``h2o-danube-3-4b``, ``phi4-mini-3.8b`` and ``deepseek-67b``.

Inputs and weights come from numpy seeds and are handed to both packages.
Tolerances: the expert matmul as in ``tests/test_kernels.py`` (fp32 atol
2e-3 / rtol 2e-4, bf16 atol 5e-1 / rtol 5e-2); layers and models at
float32 as in ``tests/test_models.py`` and ``tests/test_torch_models.py``,
atol = rtol = 1e-4, since the two frameworks sum in different orders.
Routing decisions (expert ids, ranks, drops) are compared exactly."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.config import reduced as jax_reduced  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.moe_gmm import moe_gmm as pallas_moe_gmm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.train.checkpoint import _flatten  # noqa: E402
from repro_torch.config import get_arch, reduced  # noqa: E402
from repro_torch.kernels import moe_gmm as tgmm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.layers import dense_init  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

GMM_SHAPES = [(4, 100, 96, 130), (2, 64, 256, 64), (8, 33, 48, 72)]   # E, C, D, F
GMM_TOL = {"float32": dict(atol=2e-3, rtol=2e-4), "bfloat16": dict(atol=5e-1, rtol=5e-2)}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL = dict(atol=1e-4, rtol=1e-4)
MOE_ARCHS = ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b"]
DENSE_ARCHS = ["h2o-danube-3-4b", "phi4-mini-3.8b", "deepseek-67b"]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(t, j, **tol):
    np.testing.assert_allclose(_f32(t), _f32(j), **(tol or TOL))


def _cfgs(arch, **kw):
    """The same reduced config, at float32 unless ``kw`` says otherwise, in
    both packages."""
    kw = {"dtype": "float32", **kw}
    j = dataclasses.replace(jax_reduced(jax_get_arch(arch)), **kw)
    t = dataclasses.replace(reduced(get_arch(arch)), **kw)
    return j, t


def _moe_weights(cfg, seed=0):
    """One MoE layer's weights in numpy, N(0, 1/d_in) as ``dense_init``."""
    rng = np.random.default_rng(seed)
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)

    return {"router": w(d, E), "w_gate": w(E, d, f), "w_up": w(E, d, f),
            "w_down": w(E, f, d)}


def _both(p):
    return ({k: torch.from_numpy(v) for k, v in p.items()},
            {k: jnp.asarray(v) for k, v in p.items()})


def _tokens(cfg, T, seed=1):
    return np.random.default_rng(seed).standard_normal((T, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# the expert matmul


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,D,F", GMM_SHAPES)
def test_moe_gmm_plain_matches_jax(E, C, D, F, dtype):
    rng = np.random.default_rng(21)
    tdt, jdt = DTYPES[dtype]
    x = rng.standard_normal((E, C, D)).astype(np.float32)
    w = rng.standard_normal((E, D, F)).astype(np.float32)
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    jx, jw = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    out = tref.moe_gmm_ref(tx, tw)
    assert out.dtype == tdt and out.shape == (E, C, F)
    ops.reset_launches()
    assert torch.equal(ops.moe_gmm(tx, tw), out)        # CPU: the plain version
    assert ops.LAUNCHES["moe_gmm"] == 0
    oracle = jref.moe_gmm_ref(jx, jw)
    pallas = pallas_moe_gmm(jx, jw, block_c=64, block_f=64, block_d=64, interpret=True)
    np.testing.assert_allclose(_f32(out), _f32(oracle), **GMM_TOL[dtype])
    np.testing.assert_allclose(_f32(out), _f32(pallas), **GMM_TOL[dtype])


def test_moe_gmm_on_other_devices_raises():
    x, w = torch.zeros((2, 3, 8), device="meta"), torch.zeros((2, 8, 4), device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        ops.moe_gmm(x, w)


def test_moe_gmm_wrapper_refuses_cpu_tensors():
    """Called directly, the CUDA wrapper raises before touching a CPU
    tensor: it never falls back to the plain version."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        tgmm.moe_gmm(torch.zeros((2, 3, 8)), torch.zeros((2, 8, 4)))


@pytest.mark.parametrize("xs,ws", [
    ((2, 3, 8), (3, 8, 4)),        # E differs
    ((2, 3, 8), (2, 9, 4)),        # D differs
    ((3, 8), (2, 8, 4)),           # x is not 3-D
    ((2, 3, 8), (8, 4)),           # w is not 3-D
])
def test_moe_gmm_check_inputs_rejects(xs, ws):
    with pytest.raises(ValueError, match="moe_gmm"):
        tgmm.check_inputs(torch.zeros(xs), torch.zeros(ws))


# ---------------------------------------------------------------------------
# routing and dispatch


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    tp, jp = _both(_moe_weights(jcfg))
    x = _tokens(jcfg, 37)
    tw, ti, ta = tmoe._route(tp, torch.from_numpy(x), tcfg)
    jw, ji, ja = jmoe._route(jp, jnp.asarray(x), jcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tw, jw)
    _close(ta, ja)


def test_route_breaks_exact_ties_toward_the_lower_expert():
    """A router with equal columns gives exactly equal probabilities: ties
    go to the lower index, as ``jax.lax.top_k`` breaks them."""
    jcfg, tcfg = _cfgs("mixtral-8x7b")
    p = _moe_weights(jcfg, seed=3)
    r = p["router"]
    r[:, 2] = r[:, 0]               # experts 0 and 2 tie on every token
    r[:, 3] = r[:, 1]               # and so do 1 and 3
    x = _tokens(jcfg, 16, seed=4)
    x[:4] = 0.0                     # all four tie on these tokens
    tp, jp = _both(p)
    tw, ti, ta = tmoe._route(tp, torch.from_numpy(x), tcfg)
    jw, ji, ja = jmoe._route(jp, jnp.asarray(x), jcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti[:4].tolist() == [[0, 1]] * 4
    # elsewhere the top two are the higher tied pair, the lower index first
    assert {tuple(r) for r in ti[4:].tolist()} <= {(0, 2), (1, 3)}
    _close(tw, jw)
    _close(ta, ja)


def test_moe_dense_ref_matches_jax():
    jcfg, tcfg = _cfgs("mixtral-8x7b")
    tp, jp = _both(_moe_weights(jcfg, seed=5))
    x = _tokens(jcfg, 24, seed=5)
    ty, ta = tmoe.moe_dense_ref(tp, torch.from_numpy(x), tcfg)
    jy, ja = jmoe.moe_dense_ref(jp, jnp.asarray(x), jcfg)
    _close(ty, jy)
    _close(ta, ja)


@pytest.mark.parametrize("capacity", [None, 1, 48])
def test_moe_capacity_matches_jax(capacity):
    """The default capacity, one that drops most pairs, and one ample
    enough (T * k) that nothing drops and the dense oracle agrees."""
    jcfg, tcfg = _cfgs("mixtral-8x7b")
    tp, jp = _both(_moe_weights(jcfg, seed=6))
    x = _tokens(jcfg, 24, seed=6)
    ty, ta = tmoe.moe_capacity(tp, torch.from_numpy(x), tcfg, capacity=capacity)
    jy, ja = jmoe.moe_capacity(jp, jnp.asarray(x), jcfg, capacity=capacity)
    _close(ty, jy)
    _close(ta, ja)
    if capacity == 48:
        _close(ty, tmoe.moe_dense_ref(tp, torch.from_numpy(x), tcfg)[0])


def test_moe_capacity_drops_pairs_past_the_capacity():
    """At capacity 1 each expert keeps its first pair in token order; a token
    whose both pairs were dropped gets a zero output, and a kept pair is not
    renormalised."""
    jcfg, tcfg = _cfgs("mixtral-8x7b")
    tp, _ = _both(_moe_weights(jcfg, seed=7))
    x = torch.from_numpy(_tokens(jcfg, 12, seed=7))
    y, _ = tmoe.moe_capacity(tp, x, tcfg, capacity=1)
    weights, idx, _ = tmoe._route(tp, x, tcfg)
    first = {}
    for t, row in enumerate(idx.tolist()):
        for e in row:
            first.setdefault(e, t)
    kept = [[first[e] == t for e in row] for t, row in enumerate(idx.tolist())]
    full, _ = tmoe.moe_capacity(tp, x, tcfg, capacity=24)
    for t in range(12):
        if not any(kept[t]):
            assert torch.equal(y[t], torch.zeros_like(y[t]))
        elif all(kept[t]):
            torch.testing.assert_close(y[t], full[t], atol=1e-6, rtol=1e-6)
    assert sum(map(sum, kept)) == len(first) < 24


@pytest.mark.parametrize("n_groups,capacity", [(2, None), (3, None), (4, 1)])
def test_moe_capacity_grouped_matches_jax(n_groups, capacity):
    jcfg, tcfg = _cfgs("mixtral-8x7b")
    tp, jp = _both(_moe_weights(jcfg, seed=8))
    x = _tokens(jcfg, 24, seed=8)
    ty, ta = tmoe.moe_capacity_grouped(tp, torch.from_numpy(x), tcfg, n_groups,
                                       capacity=capacity)
    jy, ja = jmoe.moe_capacity_grouped(jp, jnp.asarray(x), jcfg, n_groups,
                                       capacity=capacity)
    _close(ty, jy)
    _close(ta, ja)


@pytest.mark.parametrize("B,S", [(2, 6), (1, 24), (4, 1)])
def test_moe_apply_matches_jax(B, S):
    """The layer the transformer calls, over a batch of sequences and a
    decode step's batch of single tokens, against the JAX default mode."""
    jcfg, tcfg = _cfgs("phi3.5-moe-42b-a6.6b")
    tp, jp = _both(_moe_weights(jcfg, seed=9))
    x = np.random.default_rng(9).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    ty, ta = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    jy, ja = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    assert ty.shape == x.shape
    _close(ty, jy)
    _close(ta, ja)


def test_moe_init_tree_matches_jax_shapes():
    jcfg, tcfg = _cfgs("mixtral-8x7b", dtype="bfloat16")
    jp = jmoe.moe_init(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    tp = tmoe.moe_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jp.items()} == \
        {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in tp.items()}
    assert tp["router"].dtype == torch.float32


def test_dense_init_draws_a_stack_slice_by_slice():
    """A stacked draw equals drawing its slices one after another from the
    same generator, in the target dtype, with N(0, 1/d_in) statistics."""
    stacked = dense_init(torch.Generator().manual_seed(3), 64, 48, torch.bfloat16, (3, 2))
    gen = torch.Generator().manual_seed(3)
    slices = [dense_init(gen, 64, 48, torch.bfloat16) for _ in range(6)]
    assert stacked.shape == (3, 2, 64, 48) and stacked.dtype == torch.bfloat16
    assert torch.equal(stacked.reshape(6, 64, 48), torch.stack(slices))
    assert abs(float(stacked.float().std()) - 64 ** -0.5) < 0.01


# ---------------------------------------------------------------------------
# whole models


def _models(arch, seed, **kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jparams, params_from_jax(_flatten(jparams), device="cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_logits_and_aux_match_jax(arch):
    jcfg, tcfg, jparams, tparams = _models(arch, 10)
    toks = np.random.default_rng(10).integers(0, jcfg.vocab_size, (2, 11))
    jl, ja = JT.forward(jparams, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, ta = TT.forward(tparams, tcfg, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)
    _close(ta, ja)
    assert float(ta) > 0.0


@pytest.mark.parametrize("arch,B,S,seq_len", [
    ("mixtral-8x7b", 2, 9, 16),
    ("mixtral-8x7b", 4, 136, 144),    # prompt past the 128-token window: the ring wraps
    ("phi3.5-moe-42b-a6.6b", 2, 9, 16),
    ("h2o-danube-3-4b", 2, 9, 16),
    ("h2o-danube-3-4b", 2, 136, 144),  # prompt past the cache capacity (window 128)
    ("phi4-mini-3.8b", 2, 9, 16),
    ("deepseek-67b", 2, 9, 16),
])
def test_prefill_and_decode_logits_match_jax(arch, B, S, seq_len, monkeypatch):
    jcfg, tcfg, jparams, tparams = _models(arch, 11)
    ranks = []          # the largest rank of each MoE layer call, to see drops
    ranks_of = tmoe._ranks

    def recorded(idx, E):
        r = ranks_of(idx, E)
        ranks.append(int(r.max()))
        return r

    monkeypatch.setattr(tmoe, "_ranks", recorded)
    toks = np.random.default_rng(11).integers(0, jcfg.vocab_size, (B, S + 3))
    jl, jc = JT.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks[:, :S], jnp.int32)},
                        seq_len=seq_len)
    tl, tc = TT.prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks[:, :S])},
                        seq_len=seq_len)
    assert tc["layers"][0]["k"].shape == jc["layers"][0]["k"].shape
    if S > seq_len - 3 or (tcfg.sliding_window and S > tcfg.sliding_window):
        assert tc["layers"][0]["k"].shape[2] < S          # the ring wraps
    _close(tl, jl)
    ranks.clear()
    for i in range(3):
        nxt = toks[:, S + i:S + i + 1]
        jl, jc = JT.decode_step(jparams, jcfg, jnp.asarray(nxt, jnp.int32),
                                jnp.int32(S + i), jc)
        tl, tc = TT.decode_step(tparams, tcfg, torch.from_numpy(nxt), S + i, tc)
        _close(tl, jl)
    _close(tc["layers"][0]["k"], jc["layers"][0]["k"])
    if tcfg.moe is not None:
        # decode runs B tokens at capacity max(1, int(1.25 * 2 * B / 4)):
        # some expert ranks a pair past it, so the steps compared above drop
        capacity = max(1, int(tcfg.moe.capacity_factor * tcfg.moe.top_k * B
                              / tcfg.moe.num_experts))
        assert len(ranks) == 3 * tcfg.n_layers and max(ranks) >= capacity


@pytest.mark.parametrize("arch", DENSE_ARCHS + MOE_ARCHS)
def test_config_matches_jax(arch):
    j, t = jax_get_arch(arch), get_arch(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.block_kinds() == tuple(k.value for k in t.block_kinds())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_params_tree_matches_jax_shapes(arch):
    jcfg, tcfg = _cfgs(arch)
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
            tflat[prefix[:-1]] = tuple(node.shape)

    walk(TT.init_params(tcfg, torch.Generator().manual_seed(0)), "")
    assert tflat == {k: tuple(v.shape) for k, v in jflat.items()}
    assert "blocks/0/moe/w_gate" in tflat and "blocks/0/mlp/w_gate" not in tflat


@pytest.mark.parametrize("arch,B", [("mixtral-8x7b", 2), ("mixtral-8x7b", 4),
                                    ("phi3.5-moe-42b-a6.6b", 2)])
def test_engine_greedy_tokens_match_jax(arch, B):
    """Batch 4 of reduced mixtral (4 experts, top 2): decode capacity 2, so
    the decode steps drop pairs."""
    jcfg, tcfg = _cfgs(arch)
    jeng = JaxEngine(jcfg, batch_slots=B, max_seq_len=32, seed=3)
    params = params_from_jax(_flatten(jeng.params), device="cpu")
    teng = ServingEngine(tcfg, batch_slots=B, max_seq_len=32, device="cpu", params=params)
    prompts = np.random.default_rng(B).integers(0, jcfg.vocab_size, (B, 5)).tolist()
    ops.reset_launches()
    assert teng.generate(prompts, max_new_tokens=6) == jeng.generate(prompts, max_new_tokens=6)
    assert ops.LAUNCHES["moe_gmm"] == 0


def test_launcher_serves_mixtral_on_junctiond(capsys):
    from repro_torch.launch import serve
    summary = serve.main(["--arch", "mixtral-8x7b", "--device", "cpu", "--backend",
                          "junctiond", "--requests", "5", "--batch-slots", "2",
                          "--max-new-tokens", "3"])
    out = capsys.readouterr().out
    assert "deploying mixtral-8x7b" in out and "behind junctiond" in out
    assert "5 invocations through the junctiond runtime (simulated): median=" in out
    assert summary.n == 5 and summary.median_ms <= summary.p99_ms
