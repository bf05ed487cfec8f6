"""The engine's prefill as the card captures it (``serving.step_graph``
``PrefillGraph``), on the CPU against ``T.prefill`` and the JAX package.

On the CPU there is no CUDA graph: the engine runs the function the card
captures (``ServingEngine.prefill_step``), eagerly.  What the CPU can show:
run on static buffers, that function gives ``T.prefill``'s logits and
caches float for float, and the logits of the JAX package's jitted prefill
within ``tests/test_kernels.py``'s fp32 attention limit, 3e-5, at two
prompt lengths through one engine, whose caches every length shares; one
engine serving prompt lengths 5, 12, 5 in turn gives the JAX engine's
tokens each time (seamless with and without an ``enc_mask``, pixtral on
patch embeddings); the function reads no device value on the host (run on
fake tensors, where a ``.item()``, a ``.tolist()`` or a ``bool`` of a
tensor raises); and the shape key and the step modes.  Capture and replay
run on the card only: ``tests/test_torch_gpu.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.config import reduced as jax_reduced  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.train.checkpoint import _flatten  # noqa: E402
from repro_torch.config import get_arch, reduced  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.serving.engine import STEP_MODES, prefill_key  # noqa: E402
from repro_torch.serving.step_graph import PrefillGraph  # noqa: E402

TOL = dict(atol=3e-5, rtol=3e-5)   # tests/test_kernels.py, fp32 attention (the tightest)
#: family -> (architecture, config overrides), as tests/test_torch_step_graph.py;
#: h2o's window is cut to 8 slots, so a 12-token prompt fills its ring
FAMILIES = {
    "dense": ("qwen3-1.7b", {}),
    "windowed": ("h2o-danube-3-4b", {"sliding_window": 8}),
    "moe": ("mixtral-8x7b", {}),
    "jamba": ("jamba-v0.1-52b", {}),
    "rwkv6": ("rwkv6-1.6b", {}),
    "seamless": ("seamless-m4t-large-v2", {}),
    "pixtral": ("pixtral-12b", {"n_kv_heads": 1}),
}
SEQ = 16                     # the cache: 16 slots (h2o: its 8-slot window)
LENGTHS = (12, 5)            # past h2o's ring, then below every cache's capacity
TURNS = (5, 12, 5)           # prompt lengths served in turn by one engine
B, FRAMES = 2, 7


def _cfgs(arch, **kw):
    j = dataclasses.replace(jax_reduced(jax_get_arch(arch)), dtype="float32", **kw)
    t = dataclasses.replace(reduced(get_arch(arch)), dtype="float32", **kw)
    return j, t


def _batch(cfg, rng, S, mask=False):
    """Prompt tokens, and an enc-dec model's encoder frames (and a ragged
    mask with a fully masked row), as numpy."""
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.encdec is not None:
        width = cfg.frontend.embed_dim if cfg.frontend is not None else cfg.d_model
        batch["enc_embeds"] = rng.standard_normal((B, FRAMES, width)).astype(np.float32)
        if mask:
            batch["enc_mask"] = np.arange(FRAMES)[None] < np.array([FRAMES - 3, 0])[:, None]
    return batch


def _to_jax(batch):
    dtypes = {"tokens": jnp.int32, "enc_mask": jnp.bool_}
    return {k: jnp.asarray(v, dtypes.get(k, jnp.float32)) for k, v in batch.items()}


def _to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _engine(tcfg, jp, seq_len=SEQ, **kw):
    return ServingEngine(tcfg, batch_slots=B, max_seq_len=seq_len, device="cpu",
                         params=params_from_jax(_flatten(jp), device="cpu"), **kw)


def _assert_caches_equal(got, want, S):
    """The engine's static caches against a fresh prefill's: a KV cache on
    the slots this prompt wrote (an earlier, longer prompt's are left
    behind, and the valid mask never reads them), every other state whole."""
    for g, w in zip(got, want):
        for name in g:
            if name in ("k", "v"):
                n = min(S, g[name].shape[2])           # (groups, B, cap, Hkv, hd)
                assert torch.equal(g[name][:, :, :n], w[name][:, :, :n])
            else:
                assert torch.equal(g[name], w[name])


# ---------------------------------------------------------------------------
# the captured function against T.prefill and the JAX package's jitted prefill


@pytest.mark.parametrize("family", list(FAMILIES))
def test_captured_prefill_equals_prefill_and_jax(family):
    """One engine's ``prefill_step`` run eagerly on static copies of a
    12-token then a 5-token batch: ``T.prefill``'s logits, caches and cross
    K/V float for float, and the logits of JAX's jitted prefill within 3e-5;
    both lengths share the caches of the batch shape."""
    arch, kw = FAMILIES[family]
    jcfg, tcfg = _cfgs(arch, **kw)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(7))
    eng = _engine(tcfg, jp)
    jprefill = jax.jit(lambda p, b: JT.prefill(p, jcfg, b, seq_len=SEQ))
    rng = np.random.default_rng(7)
    for S in LENGTHS:
        batch = _batch(tcfg, rng, S)
        static = {k: v.clone() for k, v in _to_torch(batch).items()}
        logits = eng.prefill_step(static)(static)
        want, out = TT.prefill(eng.params, tcfg, _to_torch(batch), seq_len=SEQ)
        assert torch.equal(logits, want)
        state = eng._states[(B, FRAMES if tcfg.encdec is not None else 0)]
        _assert_caches_equal(state["layers"], out["layers"], S)
        if tcfg.encdec is not None:
            for got_kv, want_kv in zip(state["cross_kv"], out["cross_kv"]):
                assert all(torch.equal(g, w) for g, w in zip(got_kv, want_kv))
            assert torch.equal(state["cross_valid"], out["cross_valid"])
        jl, _ = jprefill(jp, _to_jax(batch))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl, np.float32), **TOL)
    assert len(eng._states) == 1


def test_cross_caches_take_the_prefills_shapes():
    """``T.init_cross_caches`` allocates what an enc-dec prefill returns:
    the same shapes and dtypes, so the engine's copies are exact."""
    _, tcfg = _cfgs("seamless-m4t-large-v2")
    params = TT.init_params(tcfg, torch.Generator().manual_seed(0))
    batch = _to_torch(_batch(tcfg, np.random.default_rng(0), 5))
    _, out = TT.prefill(params, tcfg, batch, seq_len=SEQ)
    bufs = TT.init_cross_caches(params, tcfg, B, FRAMES)
    assert len(bufs["cross_kv"]) == len(out["cross_kv"])
    for kv, want in zip(bufs["cross_kv"], out["cross_kv"]):
        assert [(t.shape, t.dtype) for t in kv] == [(t.shape, t.dtype) for t in want]
    assert (bufs["cross_valid"].shape, bufs["cross_valid"].dtype) == (
        out["cross_valid"].shape, out["cross_valid"].dtype)


# ---------------------------------------------------------------------------
# one engine, prompt lengths in turn


def _jax_greedy(jcfg, jp, batch, seq_len, n):
    """Greedy tokens of the JAX engine's jitted steps on ``batch``: (B, n)."""
    prefill = jax.jit(lambda p, b: JT.prefill(p, jcfg, b, seq_len=seq_len))
    decode = jax.jit(lambda p, t, pos, c: JT.decode_step(p, jcfg, t, pos, c))
    logits, caches = prefill(jp, batch)
    pos = (batch["embeds"] if "embeds" in batch else batch["tokens"]).shape[1]
    out = []
    for i in range(n):
        tok = jnp.argmax(logits[:, -1], axis=-1)
        out.append(np.asarray(tok))
        if i + 1 < n:
            logits, caches = decode(jp, tok[:, None].astype(jnp.int32), jnp.int32(pos + i),
                                    caches)
    return np.stack(out, 1).tolist()


#: case -> (family, the batch's other inputs): seamless's frames with and
#: without a ragged mask, pixtral's patch embeddings in place of tokens
TURN_CASES = {**{f: (f, None) for f in ("dense", "windowed", "moe", "jamba", "rwkv6")},
              "seamless": ("seamless", "frames"), "seamless_masked": ("seamless", "mask"),
              "pixtral": ("pixtral", "embeds")}
NEW = 5


@pytest.mark.parametrize("case", list(TURN_CASES))
def test_engine_serves_prompt_lengths_in_turn_as_jax(case):
    """One engine serves prompts of 5, 12 and 5 tokens in turn on the caches
    of its one batch shape: the JAX engine's tokens each time (the JAX
    steps' for the inputs the JAX engine takes no argument for)."""
    family, inputs = TURN_CASES[case]
    arch, kw = FAMILIES[family]
    jcfg, tcfg = _cfgs(arch, **kw)
    jeng = JaxEngine(jcfg, batch_slots=B, max_seq_len=24, seed=3) if inputs is None else None
    jp = jeng.params if jeng is not None else JT.init_params(jcfg, jax.random.PRNGKey(3))
    eng = _engine(tcfg, jp, seq_len=24)
    rng = np.random.default_rng(3)
    outs = []
    for S in TURNS:
        batch = _batch(tcfg, rng, S, mask=inputs == "mask")
        if inputs == "embeds":
            emb = rng.standard_normal((B, S, tcfg.frontend.embed_dim)).astype(np.float32)
            batch = {"embeds": emb}
        prompts = batch.pop("tokens").tolist() if "tokens" in batch else [[0] * S] * B
        got = eng.generate(prompts, max_new_tokens=NEW, inputs=_to_torch(batch))
        if jeng is not None:
            want = jeng.generate(prompts, max_new_tokens=NEW)
        else:
            jb = _to_jax(batch)
            if inputs != "embeds":
                jb["tokens"] = jnp.asarray(prompts, jnp.int32)
            want = _jax_greedy(jcfg, jp, jb, 24, NEW)
        assert got == want
        outs.append(got)
    assert outs[0] != outs[2]                       # two draws of one length
    assert len(eng._states) == 1 and eng.prefill_graphs == {} and eng.capture_s == []
    assert len(eng.step_times_s) == len(TURNS) * NEW


# ---------------------------------------------------------------------------
# what capture needs: no host sync; the shape key; the modes


def _fake_prefill(cfg):
    """The engine's prefill function on fake tensors (shapes and dtypes, no
    data), twice at one shape: a step that reads a device value on the host
    raises ``DataDependentOutputException`` here, as it would break a capture
    on the card."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._pytree import tree_map

    params = TT.init_params(cfg, torch.Generator().manual_seed(0))
    with FakeTensorMode(), torch.inference_mode():
        p = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), params)
        eng = ServingEngine(cfg, batch_slots=B, max_seq_len=SEQ, device="cpu", params=p)
        batch = {"tokens": torch.zeros((B, 5), dtype=torch.long)}
        if cfg.encdec is not None:
            width = cfg.frontend.embed_dim if cfg.frontend is not None else cfg.d_model
            batch["enc_embeds"] = torch.empty((B, FRAMES, width))
            batch["enc_mask"] = torch.ones((B, FRAMES), dtype=torch.bool)
        step = eng.prefill_step(batch)
        return [step(batch).shape for _ in range(2)]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_prefill_reads_no_device_value_on_the_host(family):
    arch, kw = FAMILIES[family]
    cfg = dataclasses.replace(reduced(get_arch(arch)), dtype="float32", **kw)
    assert _fake_prefill(cfg) == [(B, 1, cfg.vocab_size)] * 2


def test_fake_run_sees_a_host_sync_in_the_prefill(monkeypatch):
    """The check above has teeth: a prefill that reads a logit on the host
    raises on fake tensors."""
    from torch._subclasses.fake_tensor import DataDependentOutputException

    prefill = TT.prefill

    def syncing(*args, **kwargs):
        logits, out = prefill(*args, **kwargs)
        return logits * float(logits[0, 0, 0].item()), out

    monkeypatch.setattr(TT, "prefill", syncing)
    with pytest.raises(DataDependentOutputException):
        _fake_prefill(dataclasses.replace(reduced(get_arch("qwen3-1.7b")), dtype="float32"))


def test_prefill_key():
    """The key is a pure function of the batch's shapes and inputs: equal
    for two draws of one shape, apart for another length, rows, frame count
    or input."""
    rng = np.random.default_rng(0)
    tok = lambda n, S: torch.from_numpy(rng.integers(0, 9, (n, S)))  # noqa: E731
    frames = lambda n, T: torch.zeros((n, T, 4))  # noqa: E731
    assert prefill_key({"tokens": tok(2, 5)}) == (2, 5, 0, ("tokens",))
    assert prefill_key({"tokens": tok(2, 5)}) == prefill_key({"tokens": tok(2, 5)})
    assert prefill_key({"embeds": torch.zeros((3, 6, 4))}) == (3, 6, 0, ("embeds",))
    encdec = {"tokens": tok(2, 5), "enc_embeds": frames(2, 7)}
    assert prefill_key(encdec) == (2, 5, 7, ("enc_embeds", "tokens"))
    keys = {prefill_key(b) for b in (
        encdec, {**encdec, "enc_mask": torch.ones((2, 7), dtype=torch.bool)},
        {**encdec, "enc_embeds": frames(2, 9)}, {**encdec, "tokens": tok(2, 6)},
        {"tokens": tok(4, 5), "enc_embeds": frames(4, 7)})}
    assert len(keys) == 5


def test_engine_step_modes():
    """``prefill`` and ``decode`` each take a mode of ``STEP_MODES``; on the
    CPU the eager prefill serves what the default serves (the same function,
    run eagerly either way)."""
    assert STEP_MODES == ("graph", "eager")
    cfg = dataclasses.replace(reduced(get_arch("qwen3-1.7b")), dtype="float32")
    with pytest.raises(ValueError, match="prefill"):
        ServingEngine(cfg, device="cpu", prefill="jit")
    with pytest.raises(ValueError, match="decode"):
        ServingEngine(cfg, device="cpu", decode="graphs")
    prompts = [[1, 2, 3], [4, 5, 6]]
    eng = ServingEngine(cfg, batch_slots=B, max_seq_len=24, device="cpu", prefill="eager")
    assert (eng.prefill_mode, eng.decode_mode) == ("eager", "graph")
    assert eng.generate(prompts, 4) == ServingEngine(
        cfg, batch_slots=B, max_seq_len=24, device="cpu").generate(prompts, 4)


def test_a_prefill_graph_needs_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        PrefillGraph(lambda b: b["tokens"], {"tokens": torch.zeros((B, 5), dtype=torch.long)},
                     torch.device("cpu"))
