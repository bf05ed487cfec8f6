"""The dry-run tier of the port on the CPU: the attention and MoE options
that only the dry run selects, against the JAX package with the same
option, and the dry run itself on small fake meshes.

Tolerances: ``tests/test_kernels.py``'s for attention (fp32 3e-5, bf16
5e-2), 1e-4 for whole reduced models in fp32 (the two frameworks sum in
other orders), exact for what the trace counts.  Every test that starts
the fake process group tears it down (``_no_process_group``), since
several test files share a worker."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.config import reduced as jax_reduced  # noqa: E402
from repro.launch import perf as jperf  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train.checkpoint import _flatten  # noqa: E402
from repro_torch.config import InputShape, StepKind, get_arch, reduced  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import perf  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

ATTN_TOL = {"float32": dict(atol=3e-5, rtol=3e-5), "bfloat16": dict(atol=5e-2, rtol=5e-2)}
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
DT = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def _no_process_group():
    yield
    tmesh.teardown_mesh()


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close(t, j, tol):
    np.testing.assert_allclose(_np(t), _np(j), **tol)


def _qkv(B, S, T, Hq, Hkv, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, Hq, d), (B, T, Hkv, d), (B, T, Hkv, d))]
    tdt, jdt = DT[dtype]
    return ([torch.from_numpy(a).to(tdt) for a in arrs], [jnp.asarray(a, jdt) for a in arrs])


# ---------------------------------------------------------------------------
# attention options


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,T,window,q_chunk", [(40, 40, None, 16), (37, 37, 8, 16),
                                                (24, 56, None, 512), (64, 64, 16, 32)])
def test_chunked_gqa_attend_matches_jax(S, T, window, q_chunk, dtype):
    """Query chunks, padding of the last chunk, causal and windowed masks,
    queries at the last S of T positions."""
    (q, k, v), (jq, jk, jv) = _qkv(2, S, T, 4, 2, 32, dtype)
    out = tattn.chunked_gqa_attend(q, k, v, causal=True, window=window, q_chunk=q_chunk)
    ref = jattn.chunked_gqa_attend(jq, jk, jv, causal=True, window=window, q_chunk=q_chunk)
    assert out.dtype == q.dtype and tuple(out.shape) == tuple(ref.shape)
    _close(out, ref, ATTN_TOL[dtype])


def test_chunked_gqa_attend_matches_the_dense_attention():
    (q, k, v), _ = _qkv(2, 40, 40, 4, 2, 32, "float32", seed=3)
    mask = torch.ones(40, 40, dtype=torch.bool).tril()
    _close(tattn.chunked_gqa_attend(q, k, v, q_chunk=16), tattn.gqa_attend(q, k, v, mask),
           ATTN_TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mixed", [False, True])
def test_gqa_attend_mixed_precision_matches_jax(dtype, mixed):
    (q, k, v), (jq, jk, jv) = _qkv(3, 1, 50, 8, 2, 64, dtype, seed=1)
    valid = np.random.default_rng(2).random((3, 1, 50)) < 0.8
    out = tattn.gqa_attend(q, k, v, torch.from_numpy(valid), mixed_precision=mixed)
    ref = jattn.gqa_attend(jq, jk, jv, jnp.asarray(valid), mixed_precision=mixed)
    _close(out, ref, ATTN_TOL[dtype])


def _attn_params(jcfg, seed=0):
    jp = jattn.attn_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, params_from_jax(_flatten(jp), device="cpu")


@pytest.mark.parametrize("cache_update", ["dus", "select"])
@pytest.mark.parametrize("mixed", [False, True])
def test_decode_step_attention_options_match_jax(cache_update, mixed):
    """Three decode steps into a ring cache (window 8 < the 12 positions)
    with each cache update and precision, against JAX with the same
    options: the outputs and the cache after every step."""
    jcfg = dataclasses.replace(jax_reduced(jax_get_arch("qwen3-1.7b")), dtype="float32",
                               sliding_window=8)
    tcfg = dataclasses.replace(reduced(get_arch("qwen3-1.7b")), dtype="float32",
                               sliding_window=8)
    jp, tp = _attn_params(jcfg)
    B, cap = 2, 8
    rng = np.random.default_rng(4)
    hd = jcfg.resolved_head_dim
    k0 = rng.standard_normal((B, cap, jcfg.n_kv_heads, hd)).astype(np.float32)
    v0 = rng.standard_normal((B, cap, jcfg.n_kv_heads, hd)).astype(np.float32)
    jc = {"k": jnp.asarray(k0), "v": jnp.asarray(v0)}
    tc = {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(v0.copy())}
    for pos in (9, 10, 11):
        x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
        jy, jc = jattn.decode_step_attention(jp, jnp.asarray(x), jcfg, jnp.int32(pos), jc,
                                             cache_update, mixed)
        step = tattn.decode_step_inputs(tcfg, pos, B, cap, "cpu")
        ty, tc = tattn.decode_step_attention(tp, torch.from_numpy(x), tcfg, step, tc,
                                             cache_update, mixed)
        _close(ty, jy, MODEL_TOL)
        _close(tc["k"], jc["k"], MODEL_TOL)
        _close(tc["v"], jc["v"], MODEL_TOL)


def test_unknown_options_raise():
    (q, k, v), _ = _qkv(1, 4, 4, 2, 1, 8, "float32")
    cfg = dataclasses.replace(reduced(get_arch("qwen3-1.7b")), dtype="float32")
    with pytest.raises(ValueError):
        tattn._causal(q, k, v, cfg, "flash")
    with pytest.raises(TypeError):
        TT.Options(unroll=True)


# ---------------------------------------------------------------------------
# whole reduced models with each option, against JAX with the same option


def _models(arch, seed=0):
    jcfg = dataclasses.replace(jax_reduced(jax_get_arch(arch)), dtype="float32")
    tcfg = dataclasses.replace(reduced(get_arch(arch)), dtype="float32")
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jparams, params_from_jax(_flatten(jparams), device="cpu")


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mixtral-8x7b"])
def test_forward_prefill_decode_with_options_match_jax(arch):
    """forward and prefill under ``attn_impl="chunked"``, decode under
    ``cache_update="select"`` and ``mixed_precision``: logits against JAX with
    the same options; the defaults' path gives the same logits."""
    jcfg, tcfg, jp, tp = _models(arch, 5)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 14))
    jl, _ = JT.forward(jp, jcfg, {"tokens": jnp.asarray(toks[:, :11], jnp.int32)},
                       attn_impl="chunked")
    tl, _ = TT.forward(tp, tcfg, {"tokens": torch.from_numpy(toks[:, :11])},
                       attn_impl="chunked")
    _close(tl, jl, MODEL_TOL)
    _close(tl, TT.forward(tp, tcfg, {"tokens": torch.from_numpy(toks[:, :11])})[0], MODEL_TOL)

    jl, jc = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :11], jnp.int32)},
                        seq_len=16, attn_impl="chunked")
    tl, tc = TT.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks[:, :11])}, seq_len=16,
                        attn_impl="chunked")
    _close(tl, jl, MODEL_TOL)
    for i in range(3):
        nxt = toks[:, 11 + i:12 + i]
        jl, jc = JT.decode_step(jp, jcfg, jnp.asarray(nxt, jnp.int32), jnp.int32(11 + i), jc,
                                cache_update="select", mixed_precision=True)
        tl, tc = TT.decode_step(tp, tcfg, torch.from_numpy(nxt), 11 + i, tc,
                                cache_update="select", mixed_precision=True)
        _close(tl, jl, MODEL_TOL)
    _close(tc["layers"][0]["k"], jc["layers"][0]["k"], MODEL_TOL)


@pytest.mark.parametrize("groups", [2, 4])
def test_moe_local_groups_match_jax(groups, monkeypatch):
    """``moe_local_groups`` routes ``moe_apply`` (and a whole forward) to the
    grouped dispatch, as JAX's ``local_groups`` does."""
    calls = []
    grouped = tmoe.moe_capacity_grouped
    monkeypatch.setattr(tmoe, "moe_capacity_grouped",
                        lambda *a, **kw: calls.append(a[3]) or grouped(*a, **kw))
    jcfg, tcfg, jp, tp = _models("mixtral-8x7b", 6)
    x = np.random.default_rng(6).standard_normal((4, 6, jcfg.d_model)).astype(np.float32)
    mp_j = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"][0]["moe"])
    mp_t = {k: v[0] for k, v in tp["blocks"][0]["moe"].items()}
    jy, ja = jmoe.moe_apply(mp_j, jnp.asarray(x), jcfg, local_groups=groups)
    ty, ta = tmoe.moe_apply(mp_t, torch.from_numpy(x), tcfg, local_groups=groups)
    _close(ty, jy, MODEL_TOL)
    _close(ta, ja, MODEL_TOL)
    assert calls == [groups]
    tmoe.moe_apply(mp_t, torch.from_numpy(x[:, :5]), tcfg, local_groups=3)   # 20 tokens
    assert calls == [groups]             # groups that do not divide the tokens: global
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size, (4, 6))
    jl, _ = JT.forward(jp, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)},
                       moe_local_groups=groups)
    tl, _ = TT.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)}, moe_local_groups=groups)
    _close(tl, jl, MODEL_TOL)
    assert calls == [groups] * (1 + tcfg.n_layers)


# ---------------------------------------------------------------------------
# the dry run on fake meshes

FAMILIES = ["qwen3-1.7b", "mixtral-8x7b", "jamba-v0.1-52b", "rwkv6-1.6b",
            "seamless-m4t-large-v2", "pixtral-12b"]
SMALL = {StepKind.TRAIN: InputShape("train_4k", 64, 8, StepKind.TRAIN),
         StepKind.PREFILL: InputShape("prefill_32k", 64, 8, StepKind.PREFILL),
         StepKind.DECODE: InputShape("decode_32k", 64, 8, StepKind.DECODE)}


def _reduced(arch, **kw):
    return dataclasses.replace(reduced(get_arch(arch)), **{"dtype": "bfloat16", **kw})


@pytest.mark.parametrize("arch,shape", [(a, s) for a, s in zip(
    FAMILIES, ["train_4k", "train_4k", "train_4k", "prefill_32k", "train_4k", "decode_32k"])])
def test_run_pair_on_a_2x2_mesh(arch, shape):
    """Every family's reduced config through ``run_pair`` on data=2 x model=2
    at the registered shape's sizes (the trace holds no data): a finite
    roofline, memory and collectives on the model axis."""
    mesh = tmesh.make_mesh((2, 2), ("data", "model"))
    rec = dr.run_pair(arch, shape, probes=False, verbose=False, mesh=mesh, cfg=_reduced(arch))
    r = rec["roofline"]
    assert rec["mesh"] == "data2xmodel2" and rec["chips"] == 4
    for k in ("compute_s", "memory_s", "collective_s", "step_time_s", "useful_ratio"):
        assert np.isfinite(r[k]) and r[k] > 0, k
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["params_bytes"] > 0
    assert rec["cost"]["collective bytes by axis"].get("model", 0) > 0


def test_trace_on_one_device_counts_what_flop_counter_counts():
    """On a 1x1 mesh the trace's flops equal ``FlopCounterMode`` over a real
    CPU run of the same training step, and no collective moves a byte."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.train_loop import make_train_step
    from repro_torch.models.layers import tree_map

    cfg = _reduced("qwen3-1.7b", dtype="float32")
    shape = SMALL[StepKind.TRAIN]
    mesh = tmesh.make_mesh((1, 1), ("data", "model"))
    counts = dr.trace(cfg, shape, mesh, sh.Policy())
    assert counts["collectives"].bytes_per_chip == 0

    params = tree_map(lambda p: p.requires_grad_(True),
                      TT.init_params(cfg, torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 64)))
             for k in ("tokens", "labels")}
    step = make_train_step(cfg, AdamWConfig(), remat=True,
                           **dr._options(cfg, shape, mesh, sh.Policy()))
    with FlopCounterMode(display=False) as fc:
        step(params, init_state(params), batch)
    assert counts["flops"] == fc.get_total_flops() > 0


def test_probes_extrapolate_to_the_full_depth():
    """For a homogeneous stack the two probe depths, extrapolated, give the
    full-depth trace's counts."""
    mesh = tmesh.make_mesh((2, 2), ("data", "model"))
    cfg = _reduced("qwen3-1.7b", n_layers=6)
    shape = SMALL[StepKind.PREFILL]
    la, lb = dr.probe_layer_counts(cfg)
    pts = [dr.rl.probe_from_trace(n, dr.trace(dr.with_layers(cfg, n), shape, mesh,
                                              sh.Policy())) for n in (la, lb)]
    full = dr.trace(cfg, shape, mesh, sh.Policy())
    tot = dr.rl.extrapolate(*pts, cfg.n_layers)
    assert tot["flops"] == pytest.approx(full["flops"], rel=1e-12)
    assert tot["bytes"] == pytest.approx(full["bytes"], rel=1e-12)
    assert tot["coll"] == pytest.approx(full["collectives"].bytes_per_chip, rel=1e-12)


def test_expert_parallel_moves_tokens_by_all_to_all():
    """perf's expert-parallel variant on reduced mixtral: the expert dim
    sharded over 'model' makes DTensor move the dispatch by all-to-all,
    which the trace keeps as one (not as an all-gather and a chunk)."""
    mesh = tmesh.make_mesh((2, 2), ("data", "model"))
    pol = dict((n, p) for n, p, _ in perf.variants_for("train_4k", "mixtral-8x7b"))
    cfg = _reduced("mixtral-8x7b")
    ep = dr.trace(cfg, SMALL[StepKind.TRAIN], mesh, pol["chunked_attn+ep"])
    assert ep["collectives"].by_kind.get("all-to-all", 0) > 0


def test_variants_match_jax():
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        t = perf.variants_for(shape, "mixtral-8x7b")
        j = jperf.variants_for(shape, "mixtral-8x7b")
        assert [n for n, _, _ in t] == [n for n, _, _ in j]
        assert [dataclasses.asdict(p) for _, p, _ in t] == [dataclasses.asdict(p)
                                                           for _, p, _ in j]
        for _, _, hyp in t:
            assert "MXU" not in hyp and "VMEM" not in hyp and "ICI" not in hyp


def test_main_passes_and_fails_by_its_pairs(tmp_path, monkeypatch, capsys):
    """``main`` saves a record a pair and prints ALL DRY-RUNS PASSED; a pair
    that raises is printed and counted, and ``main`` exits 1."""
    def small_pair(arch, shape, **kw):
        mesh = tmesh.make_mesh((2, 2), ("data", "model"))
        return real(arch, shape, mesh=mesh, cfg=_reduced(arch), **kw)

    real = dr.run_pair
    monkeypatch.setattr(dr, "run_pair", small_pair)
    dr.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k", "--no-probes",
             "--out", str(tmp_path)])
    assert "ALL DRY-RUNS PASSED" in capsys.readouterr().out
    assert (tmp_path / "qwen3-1.7b__decode_32k__data2xmodel2.json").exists()

    def broken(*a, **kw):
        raise RuntimeError("no sharding rule")

    monkeypatch.setattr(dr, "run_pair", broken)
    with pytest.raises(SystemExit) as e:
        dr.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k", "--out", str(tmp_path)])
    assert e.value.code == 1
    assert "1 FAILURES" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the port's DTensor rules (``trace_ops.aten_shardings``), held to torch's own


def _twins():
    """Each ruled ATen op's twin: the same schema in namespace
    ``test_dryrun_twin`` (and, where ``other`` is a Tensor, an overload
    ``sc`` taking a Python number), running the ATen op, placed by the port's
    rule.  DTensor takes torch's own rule for the ATen op, and the port's for
    its twin."""
    from torch.distributed.tensor.experimental import register_sharding
    from repro_torch.kernels import trace_ops
    if _TWINS:
        return _TWINS
    lib = torch.library.Library("test_dryrun_twin", "DEF")
    _TWINS["lib"] = lib
    for op, rule in trace_ops.aten_shardings().items():
        schema = str(op._schema).split("::", 1)[1]
        name = schema.split("(")[0]
        base = name.split(".")[0]
        variants = [(schema, name)]
        if "Tensor other" in schema:
            variants.append((schema.replace("Tensor other", "Scalar other").replace(
                name, base + ".sc", 1), base + ".sc"))
        for sch, nm in variants:
            lib.define(sch)
            lib.impl(nm, (lambda op: lambda *a, **k: op(*a, **k))(op),
                     "CompositeExplicitAutograd")
            packet = getattr(torch.ops.test_dryrun_twin, base)
            twin = getattr(packet, nm.split(".")[1] if "." in nm else "default")
            register_sharding(twin)(rule)
            _TWINS[(op, nm.endswith(".sc"))] = twin
    return _TWINS


_TWINS = {}
RULE_PAIRS = [  # arch, shape, config changes, ops the trace must run
    ("mixtral-8x7b", "train_4k", {}, {"index_put_", "index_put", "index", "scatter"}),
    ("jamba-v0.1-52b", "prefill_32k", {}, {"add", "softplus", "silu"}),
    ("h2o-danube-3-4b", "prefill_32k", {"sliding_window": 16}, {"roll"}),
    ("qwen3-1.7b", "train_4k", {}, {"pow", "mul", "silu_backward", "where"})]


@pytest.mark.parametrize("arch,shape,kw,expect", RULE_PAIRS,
                         ids=[a + "-" + s for a, s, _, _ in RULE_PAIRS])
def test_port_rules_place_as_torch_does(arch, shape, kw, expect, monkeypatch):
    """Every call of a ruled op in a reduced trace on a 2x2 mesh, run again
    alone under torch's own rule and under the port's (its twin): the same
    output placements and the same collectives.  (torch 2.13 has rules of its
    own for these ops; 2.11, on the card's host, has not or places them
    otherwise, and registers the port's.)"""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils._pytree import tree_leaves
    from repro_torch.kernels import ops, trace_ops
    if not trace_ops.torch_has_aten_rules():
        pytest.skip(f"torch {torch.__version__} has no rules of its own to hold the port's to")
    ruled = trace_ops.aten_shardings()
    calls = []
    real = dr.StepCounter._dtensor_op

    def spy(self, func, args, kwargs):
        if func in ruled and self.counting:
            calls.append((func, args, kwargs))
        return real(self, func, args, kwargs)

    monkeypatch.setattr(dr.StepCounter, "_dtensor_op", spy)
    mesh = tmesh.make_mesh((2, 2), ("data", "model"))
    cfg = _reduced(arch, **kw)
    shp = SMALL[{"train_4k": StepKind.TRAIN, "prefill_32k": StepKind.PREFILL}[shape]]
    dr.trace(cfg, shp, mesh, sh.Policy())
    monkeypatch.setattr(dr.StepCounter, "_dtensor_op", real)
    assert calls, "the trace ran no ruled op"
    twins = _twins()

    def run(func, args, kwargs):
        counter = dr.StepCounter(mesh)
        counter.counting = True
        with ops.meta_trace(), implicit_replication(), dr._alltoall_kept(mesh), counter.mode:
            out = func(*args, **kwargs)
        assert not counter.replicated
        return ([tuple(t.placements) for t in tree_leaves(out) if isinstance(t, DTensor)],
                sorted(counter.log.calls))

    seen = set()
    for func, args, kwargs in calls:
        scalar = len(args) > 1 and isinstance(args[1], (int, float))
        twin = twins.get((func, scalar)) or twins[(func, False)]
        assert run(twin, args, kwargs) == run(func, args, kwargs), \
            (func, [getattr(a, "placements", a) for a in tree_leaves(args)])
        seen.add(func)
    assert expect <= {f.overloadpacket.__name__ for f in seen}, seen


@torch.library.custom_op("test_dryrun::unplaced", mutates_args=())
def _unplaced(x: torch.Tensor) -> torch.Tensor:
    """An op DTensor has no rule for."""
    return x.clone()


@_unplaced.register_fake
def _(x):
    return torch.empty_like(x)


_unplaced.register_autograd(lambda ctx, g: g)


def _with_unplaced_op(monkeypatch):
    """Route the experts' input through ``_unplaced``."""
    ffn = tmoe._expert_ffn
    monkeypatch.setattr(tmoe, "_expert_ffn", lambda p, xe: ffn(p, _unplaced(xe)))


def test_a_replicated_op_fails_the_pair(monkeypatch):
    """An op with no DTensor rule runs replicated: the record lists it and
    ``require_placed`` raises; the same pair without it passes."""
    mesh = tmesh.make_mesh((2, 2), ("data", "model"))
    cfg = _reduced("mixtral-8x7b")
    rec = dr.run_pair("mixtral-8x7b", "train_4k", probes=False, verbose=False, mesh=mesh,
                      cfg=cfg, shape=SMALL[StepKind.TRAIN])
    assert rec["cost"][dr.REPLICATED] == {}
    dr.require_placed(rec)
    _with_unplaced_op(monkeypatch)
    rec = dr.run_pair("mixtral-8x7b", "train_4k", probes=False, verbose=False, mesh=mesh,
                      cfg=cfg, shape=SMALL[StepKind.TRAIN])
    assert rec["cost"][dr.REPLICATED] == {"test_dryrun.unplaced.default": 2 * cfg.n_layers}
    with pytest.raises(AssertionError, match="test_dryrun.unplaced"):
        dr.require_placed(rec)


def test_main_fails_a_pair_with_a_replicated_op_and_keeps_its_record(tmp_path, monkeypatch,
                                                                     capsys):
    def small_pair(arch, shape, **kw):
        mesh = tmesh.make_mesh((2, 2), ("data", "model"))
        return real(arch, shape, mesh=mesh, cfg=_reduced(arch), shape=SMALL[StepKind.TRAIN],
                    **kw)

    real = dr.run_pair
    monkeypatch.setattr(dr, "run_pair", small_pair)
    _with_unplaced_op(monkeypatch)
    with pytest.raises(SystemExit) as e:
        dr.main(["--arch", "mixtral-8x7b", "--shape", "train_4k", "--no-probes",
                 "--out", str(tmp_path)])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "1 FAILURES" in out and "ops run replicated" in out
    saved = json.loads((tmp_path / "mixtral-8x7b__train_4k__data2xmodel2.json").read_text())
    assert saved["cost"][dr.REPLICATED] == {"test_dryrun.unplaced.default": 4}


def test_two_traces_in_one_process_are_equal(tmp_path):
    """A reduced MoE training step traced twice in one process (at a shape no
    other test traces, so that the first trace finds DTensor's caches cold):
    every figure equal to the byte, and ``compare_records`` finds none apart."""
    mesh = tmesh.make_mesh((2, 2), ("data", "model"))
    cfg = _reduced("mixtral-8x7b")
    shape = InputShape("train_4k", 48, 4, StepKind.TRAIN)
    recs = [dr.run_pair("mixtral-8x7b", "train_4k", probes=False, verbose=False, mesh=mesh,
                        cfg=cfg, shape=shape) for _ in range(2)]
    figures = [dr.record_figures(r) for r in recs]
    assert figures[0] == figures[1]
    assert set(figures[0]) >= {"peak", "flops", "bytes accessed", "kind all-to-all",
                               "axis model", "axis data"}
    for r in recs:
        assert r["cost"][dr.REPLICATED] == {} and r["cost"]["view gathers"] == 0
    for i, r in enumerate(recs):
        dr.save_record(r, str(tmp_path / str(i)))
    assert dr.compare_records(str(tmp_path / "0"), str(tmp_path / "1")) == 0


VIEW_CASES = [  # shape, size, placements (S d / R / P) on a 32 x 8 mesh, expected
    ((32, 16, 128, 64), (512, 128, 64), ("S0", "S1"), ("S0", "S0")),     # merge, both sharded
    ((512, 128, 128), (32, 16, 128, 128), ("S0", "S0"), ("S0", "S1")),   # and split back
    ((256, 8, 64), (256, 512), ("S0", "S1"), ("S0", "S1")),              # merge, second sharded
    ((4, 64), (256,), ("R", "S1"), ("R", "S0")),
    ((2048,), (2, 1024), ("S0", "S0"), ("S1", "S1")),                    # first part too small
    ((32, 1, 64), (32, 64), ("S0", "S2"), ("S0", "S1")),                 # a size-1 dimension
    ((32, 64), (32, 1, 64), ("S0", "S1"), ("S0", "S2")),
    ((64, 3), (192,), ("P", "S0"), ("P", "S0")),
    ((64, 512), (64, 1, 512), ("S0", "S1"), ("S0", "S2")),               # a 1 after a run
    ((4, 320, 512), (4, 320, 1, 512), ("P", "S2"), ("P", "S3")),
    ((256, 1, 64), (64, 4, 1, 1, 64), ("S0", "S2"), ("S0", "S4")),
    ((256,), (2, 128), ("S0", "S0"), None),                               # 128 / 32 by 8: no
]


def _pl(code):
    from torch.distributed.tensor import Partial, Replicate, Shard
    return {"R": Replicate(), "P": Partial()}.get(code) or Shard(int(code[1:]))


@pytest.mark.parametrize("shape,size,placements,expected", VIEW_CASES)
def test_view_placements(shape, size, placements, expected):
    """The port's view rule: merged dimensions sharded on two mesh dimensions
    become one dimension sharded twice (the local shape of torch 2.13's
    strided shard) and go back when split."""
    got = dr.view_placements(shape, size, [_pl(p) for p in placements], (32, 8))
    assert got == (None if expected is None else [_pl(p) for p in expected])


def test_a_view_dtensor_refuses_is_placed_by_the_port(monkeypatch):
    """A view DTensor refuses (as torch 2.11 refuses to merge a sharded
    dimension into the one before it) is taken on the local shard and placed
    by ``view_placements``: no collective, counted in ``views placed``.  One
    the rule cannot place either is viewed once its sharded mesh dimensions
    are gathered, each all-gather recorded (``view gathers``)."""
    from torch.distributed.tensor import DTensor, Shard

    mesh = tmesh.make_mesh((2, 2), ("data", "model"))
    counter = dr.StepCounter(mesh)
    counter.counting = True
    view = torch.ops.aten.view.default

    def refusing(x, size):
        if isinstance(x, DTensor) and any(isinstance(p, Shard) for p in x.placements):
            raise RuntimeError("Attempted to flatten multiple dimensions")
        return view(x, size)

    def sharded(local, placements, shape):
        return DTensor.from_local(torch.empty(local, device="meta"), mesh, placements,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=dr._contiguous_stride(shape))

    y = counter._view(refusing, (sharded((2, 3, 5), [Shard(0), Shard(1)], (4, 6, 5)),
                                 [24, 5]), {})
    assert tuple(y.shape) == (24, 5) and tuple(y.to_local().shape) == (6, 5)
    assert list(y.placements) == [Shard(0), Shard(0)]
    assert counter.views_placed == 1 and counter.view_gathers == 0 and not counter.log.calls

    monkeypatch.setattr(dr, "view_placements", lambda *a: None)
    y = counter._view(refusing, (sharded((2, 3, 5), [Shard(0), Shard(1)], (4, 6, 5)),
                                 [24, 5]), {})
    assert tuple(y.shape) == (24, 5) and tuple(y.to_local().shape) == (24, 5)
    assert counter.views_placed == 1 and counter.view_gathers == 2
    assert [c[0] for c in counter.log.calls] == ["all-gather", "all-gather"]


def test_a_collectives_output_is_its_buffer_once():
    """A gather's output is one new buffer: held from the collective on,
    and the wrapper and wait DTensor put around it (a new tensor on the
    meta device, the same buffer on a card) move no bytes and hold nothing
    more; a view of it holds nothing either."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.kernels import ops

    mesh = tmesh.make_mesh((2, 2), ("data", "model"))
    counter = dr.StepCounter(mesh)
    counter.counting = True
    x = DTensor.from_local(torch.empty((4, 1024), device="meta"), mesh, [Shard(0), Replicate()],
                           run_check=False, shape=torch.Size((8, 1024)), stride=(1024, 1))
    with ops.meta_trace(), counter.mode:
        before = counter.live
        y = x.redistribute(mesh, [Replicate(), Replicate()]).to_local()
        rows = y[2:6]
        assert counter.live - before == 8 * 1024 * 4 and counter.bytes == 0
        z = rows * 2
    assert counter.log.calls == [("all-gather", 8 * 1024 * 4, 2, "data")]
    assert counter.bytes == 2 * 4 * 1024 * 4             # the product alone
    assert counter.peak - before == 8 * 1024 * 4 + 4 * 1024 * 4
    del z


VIEW_PAIRS = [  # arch, step, config changes, whether torch makes a strided shard
    ("mixtral-8x7b", StepKind.TRAIN, {}, False),
    ("seamless-m4t-large-v2", StepKind.PREFILL, {}, True),
    ("h2o-danube-3-4b", StepKind.PREFILL, {"sliding_window": 16}, False),
    ("deepseek-67b", StepKind.DECODE, {}, True),
    ("jamba-v0.1-52b", StepKind.TRAIN, {}, False),
    ("rwkv6-1.6b", StepKind.PREFILL, {}, False)]


@pytest.mark.parametrize("arch,kind,kw,strided", VIEW_PAIRS,
                         ids=[a + "-" + k.value for a, k, _, _ in VIEW_PAIRS])
def test_view_placements_place_as_torchs_own_view(arch, kind, kw, strided, monkeypatch):
    """Every view of a DTensor in a reduced trace on a 2x2 mesh, viewed again
    by DTensor alone: where torch places it in plain shards, ``view_placements``
    gives the same placements; where torch makes a strided shard, the same
    local shape and the same tensor dimension for each mesh dimension."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.kernels import trace_ops
    if not trace_ops.torch_has_aten_rules():
        pytest.skip(f"torch {torch.__version__} lacks 2.13's view rules to hold the port's to")
    calls = {}
    real = dr.StepCounter._view

    def spy(self, func, args, kwargs):
        if self.counting:
            calls[(func, tuple(args[0].shape), tuple(args[0].placements), tuple(args[1]))] = 1
        return real(self, func, args, kwargs)

    monkeypatch.setattr(dr.StepCounter, "_view", spy)
    mesh = tmesh.make_mesh((2, 2), ("data", "model"))
    dr.trace(_reduced(arch, **kw), SMALL[kind], mesh, sh.Policy())
    assert calls, "the trace viewed no DTensor"
    seen_strided = False
    for func, shape, placements, size in calls:
        local = list(shape)
        for m, p in enumerate(placements):
            if isinstance(p, Shard):
                local[p.dim] //= mesh.size(m)
        x = DTensor.from_local(torch.empty(local, device="meta"), mesh, placements,
                               run_check=False, shape=torch.Size(shape),
                               stride=dr._contiguous_stride(shape))
        size = dr._view_size(shape, size)
        port = dr.view_placements(shape, size, list(placements), mesh.shape)
        out = func(x, list(size))
        case = (shape, placements, size, out.placements, port)
        if all(type(p) in (Shard, Replicate, Partial) for p in out.placements):
            assert port == list(out.placements), case
            continue
        seen_strided = True
        assert port is not None, case
        port_local = list(size)
        for m, p in enumerate(port):
            if isinstance(p, Shard):
                port_local[p.dim] //= mesh.size(m)
        assert tuple(out.to_local().shape) == tuple(port_local), case
        assert [getattr(p, "dim", p) for p in out.placements] == \
            [getattr(p, "dim", p) for p in port], case
    assert seen_strided == strided, seen_strided


COMPARE_CASES = [  # records in A, records in B, expected return
    (("qwen3-1.7b",), ("qwen3-1.7b",), 0),
    (("qwen3-1.7b", "rwkv6-1.6b"), ("qwen3-1.7b",), 1),      # a pair one sweep lost
    (("qwen3-1.7b",), ("rwkv6-1.6b",), 2),                    # none shared
    ((), (), 1)]


@pytest.mark.parametrize("in_a,in_b,expected", COMPARE_CASES)
def test_compare_records_counts_a_missing_pair_as_apart(in_a, in_b, expected, tmp_path, capsys):
    """A record only one directory holds counts as apart and is printed, and
    two directories that share no record fail; ``main --compare`` exits 1
    wherever the count is above 0."""
    def rec(arch):
        return {"arch": arch, "shape": "decode_32k", "mesh": "data2xmodel2",
                "memory": {"peak_bytes": 1e9},
                "cost": {"flops": 1e12, "bytes accessed": 1e10,
                         "collective bytes by kind": {"all-gather": 1e8},
                         "collective bytes by axis": {"model": 1e8},
                         dr.REPLICATED: {}, "view gathers": 0}}

    for d, archs in (("a", in_a), ("b", in_b)):
        (tmp_path / d).mkdir()
        for arch in archs:
            dr.save_record(rec(arch), str(tmp_path / d))
    dirs = [str(tmp_path / "a"), str(tmp_path / "b")]
    assert dr.compare_records(*dirs) == expected
    out = capsys.readouterr().out
    assert ("only in" in out) == (set(in_a) != set(in_b))
    with pytest.raises(SystemExit) as e:
        dr.main(["--compare", *dirs])
    assert e.value.code == (1 if expected else 0)
