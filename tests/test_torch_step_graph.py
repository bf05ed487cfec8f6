"""The decode step with ``pos`` on the device, and the engine that captures
it on the card (``serving.step_graph``), on the CPU against the JAX package.

On the CPU there is no CUDA graph: the engine runs the step function the
card captures, eagerly.  What the CPU can show: a tensor ``pos`` gives the
int ``pos``'s logits and caches float for float, and both equal the JAX
package's jitted ``decode_step`` (pos below the cache's capacity and past
it, where the cache is a ring) within ``tests/test_kernels.py``'s fp32
attention limit, 3e-5, the tightest of its fp32 limits; the engine's static caches, reused across ``generate``
calls, give the JAX engine's tokens each time; and the step reads no
device value on the host (run on fake tensors, where a ``.item()``, a
``.tolist()`` or a ``bool`` of a tensor raises).  Capture and replay run
on the card only: ``tests/test_torch_gpu.py``.
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
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.serving.step_graph import DecodeGraph  # noqa: E402

TOL = dict(atol=3e-5, rtol=3e-5)   # tests/test_kernels.py, fp32 attention (the tightest)
#: family -> (architecture, config overrides); h2o's window is cut to 8
#: slots, under the 16-slot cache, so that its ring and window both bind
FAMILIES = {
    "dense": ("qwen3-1.7b", {}),
    "windowed": ("h2o-danube-3-4b", {"sliding_window": 8}),
    "moe": ("mixtral-8x7b", {}),
    "jamba": ("jamba-v0.1-52b", {}),
    "rwkv6": ("rwkv6-1.6b", {}),
    "seamless": ("seamless-m4t-large-v2", {}),
    "pixtral": ("pixtral-12b", {"n_kv_heads": 1}),
}
SEQ = 16                                    # the cache: 16 slots (h2o: its 8-slot window)
#: regime -> (prompt length, decode steps): positions 5-7 stay below every
#: cache's capacity; 12-17 pass h2o's 8 slots at once and the others' 16
REGIMES = {"below_cap": (5, 3), "past_cap": (12, 6)}
B, FRAMES = 2, 7


def _cfgs(arch, **kw):
    j = dataclasses.replace(jax_reduced(jax_get_arch(arch)), dtype="float32", **kw)
    t = dataclasses.replace(reduced(get_arch(arch)), dtype="float32", **kw)
    return j, t


def _close(t, j):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **TOL)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _batch(cfg, rng, S, n=B):
    """Prompt tokens, and an enc-dec model's encoder frames, as numpy."""
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (n, S))}
    if cfg.encdec is not None:
        width = cfg.frontend.embed_dim if cfg.frontend is not None else cfg.d_model
        batch["enc_embeds"] = rng.standard_normal((n, FRAMES, width)).astype(np.float32)
    return batch


def _jax_steps(jcfg, seq_len):
    """The JAX engine's two jitted steps."""
    prefill = jax.jit(lambda p, b: JT.prefill(p, jcfg, b, seq_len=seq_len))
    decode = jax.jit(lambda p, t, pos, c: JT.decode_step(p, jcfg, t, pos, c))
    return prefill, decode


def _to_jax(batch):
    return {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# pos as a device tensor


@pytest.mark.parametrize("regime", list(REGIMES))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_tensor_pos_equals_int_pos_and_jax(family, regime):
    """From one prefill, decode steps on teacher-forced tokens with ``pos``
    an int and a 0-d int64 tensor give the same logits and caches float for
    float, and the JAX package's jitted step's within 3e-5."""
    arch, kw = FAMILIES[family]
    S, n = REGIMES[regime]
    jcfg, tcfg = _cfgs(arch, **kw)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(7))
    tp = params_from_jax(_flatten(jp), device="cpu")
    rng = np.random.default_rng(7)
    batch = _batch(tcfg, rng, S)
    jprefill, jdecode = _jax_steps(jcfg, SEQ)
    jl, jc = jprefill(jp, _to_jax(batch))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, c_int = TT.prefill(tp, tcfg, tb, seq_len=SEQ)
    tl, c_ten = TT.prefill(tp, tcfg, tb, seq_len=SEQ)
    _close(tl, jl)
    caps = [c["k"].shape[2] for c in c_ten["layers"] if "k" in c]   # (groups, B, cap, ...)
    cap = caps[0] if caps else SEQ
    seen = []
    for pos in range(S, S + n):
        nxt = rng.integers(0, tcfg.vocab_size, (B, 1))
        jl, jc = jdecode(jp, jnp.asarray(nxt, jnp.int32), jnp.int32(pos), jc)
        l_int, c_int = TT.decode_step(tp, tcfg, torch.from_numpy(nxt), pos, c_int)
        l_ten, c_ten = TT.decode_step(tp, tcfg, torch.from_numpy(nxt),
                                      torch.tensor(pos, dtype=torch.long), c_ten)
        assert torch.equal(l_int, l_ten)
        assert all(torch.equal(a, b) for a, b in zip(_leaves(c_int), _leaves(c_ten)))
        _close(l_ten, jl)
        seen.append(pos >= cap)
    assert any(seen) == (regime == "past_cap")


# ---------------------------------------------------------------------------
# the engine's static state across requests


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-v0.1-52b"])
def test_engine_serves_consecutive_requests_as_the_jax_engine(arch):
    """One engine, three ``generate`` calls (two prompts, then the first
    again) on its reused caches: each gives the JAX engine's tokens, so the
    recurrent states left by one request do not reach the next."""
    jcfg, tcfg = _cfgs(arch)
    jeng = JaxEngine(jcfg, batch_slots=B, max_seq_len=32, seed=3)
    teng = ServingEngine(tcfg, batch_slots=B, max_seq_len=32, device="cpu",
                         params=params_from_jax(_flatten(jeng.params), device="cpu"))
    rng = np.random.default_rng(11)
    first, second = (rng.integers(0, tcfg.vocab_size, (B, 9)).tolist() for _ in range(2))
    outs = []
    for prompts in (first, second, first):
        got = teng.generate(prompts, max_new_tokens=6)
        assert got == jeng.generate(prompts, max_new_tokens=6)
        outs.append(got)
    assert outs[0] == outs[2] and outs[0] != outs[1]
    assert teng.capture_s == [] and len(teng.step_times_s) == 3 * 6


def _jax_greedy(jcfg, jp, batch, seq_len, n):
    """Greedy tokens of the JAX engine's jitted steps on ``batch``: (B, n)."""
    prefill, decode = _jax_steps(jcfg, seq_len)
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


def test_engine_serves_consecutive_enc_dec_requests_as_the_jax_steps():
    """Reduced seamless-m4t through the engine with its encoder frames as
    ``inputs``, twice with other prompts and frames: the tokens of the JAX
    engine's jitted steps each time (the JAX engine takes no encoder
    inputs), so each prefill's cross K/V reaches the static buffers the
    step reads."""
    jcfg, tcfg = _cfgs("seamless-m4t-large-v2")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(5))
    teng = ServingEngine(tcfg, batch_slots=B, max_seq_len=24, device="cpu",
                         params=params_from_jax(_flatten(jp), device="cpu"))
    rng = np.random.default_rng(5)
    outs = []
    for _ in range(2):
        batch = _batch(tcfg, rng, 6)
        got = teng.generate(batch["tokens"].tolist(), max_new_tokens=5,
                            inputs={"enc_embeds": torch.from_numpy(batch["enc_embeds"])})
        assert got == _jax_greedy(jcfg, jp, _to_jax(batch), 24, 5)
        outs.append(got)
    assert outs[0] != outs[1]


def test_engine_takes_frontend_embeddings_as_the_prompt():
    """Reduced pixtral through the engine on a prompt of patch embeddings
    (``inputs={"embeds": ...}``): the JAX steps' greedy tokens."""
    jcfg, tcfg = _cfgs("pixtral-12b", n_kv_heads=1)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(6))
    teng = ServingEngine(tcfg, batch_slots=B, max_seq_len=24, device="cpu",
                         params=params_from_jax(_flatten(jp), device="cpu"))
    emb = np.random.default_rng(6).standard_normal((B, 10, jcfg.frontend.embed_dim))
    emb = emb.astype(np.float32)
    got = teng.generate([[0] * 10] * B, max_new_tokens=5,
                        inputs={"embeds": torch.from_numpy(emb)})
    assert got == _jax_greedy(jcfg, jp, {"embeds": jnp.asarray(emb)}, 24, 5)
    with pytest.raises(ValueError):
        teng.generate([[0] * 9] * B, max_new_tokens=2, inputs={"embeds": torch.from_numpy(emb)})
    assert not teng.batcher.running and not teng.batcher.waiting   # refused before admission


# ---------------------------------------------------------------------------
# what capture needs: no host sync, fixed inputs, counts per replay


def _fake_step(cfg, step=TT.decode_step):
    """Prefill and one decode step with a tensor ``pos`` on fake tensors
    (shapes and dtypes, no data): a step that reads a device value on the
    host raises ``DataDependentOutputException`` here, as it would break a
    capture on the card."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._pytree import tree_map

    params = TT.init_params(cfg, torch.Generator().manual_seed(0))
    with FakeTensorMode(), torch.inference_mode():
        p = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), params)
        batch = {"tokens": torch.zeros((B, 5), dtype=torch.long)}
        if cfg.encdec is not None:
            width = cfg.frontend.embed_dim if cfg.frontend is not None else cfg.d_model
            batch["enc_embeds"] = torch.empty((B, FRAMES, width))
        _, caches = TT.prefill(p, cfg, batch, seq_len=SEQ)
        logits, _ = step(p, cfg, torch.zeros((B, 1), dtype=torch.long),
                         torch.zeros((), dtype=torch.long), caches)
    return logits


@pytest.mark.parametrize("family", list(FAMILIES))
def test_decode_step_reads_no_device_value_on_the_host(family):
    arch, kw = FAMILIES[family]
    cfg = dataclasses.replace(reduced(get_arch(arch)), dtype="float32", **kw)
    assert _fake_step(cfg).shape == (B, 1, cfg.vocab_size)


def test_fake_run_sees_a_host_sync():
    """The check above has teeth: a step that asks the host for ``pos``
    raises on fake tensors."""
    from torch._subclasses.fake_tensor import DataDependentOutputException

    def syncing(params, cfg, tokens, pos, caches):
        return TT.decode_step(params, cfg, tokens, int(pos.item()), caches)

    with pytest.raises(DataDependentOutputException):
        _fake_step(dataclasses.replace(reduced(get_arch("qwen3-1.7b")), dtype="float32"),
                   syncing)


def test_recurrent_states_are_the_scan_states():
    cfg = dataclasses.replace(reduced(get_arch("jamba-v0.1-52b")), dtype="float32")
    params = TT.init_params(cfg, torch.Generator().manual_seed(0))
    caches = TT.init_caches(params, cfg, B, SEQ)
    states = TT.recurrent_states(cfg, caches)
    assert {id(t) for t in states} == {id(t) for c in caches if "k" not in c
                                       for t in c.values()}
    assert states and not any(t is c[k] for c in caches if "k" in c for k in c for t in states)
    qwen = dataclasses.replace(reduced(get_arch("qwen3-1.7b")), dtype="float32")
    assert TT.recurrent_states(qwen, TT.init_caches(TT.init_params(
        qwen, torch.Generator().manual_seed(0)), qwen, B, SEQ)) == []


def test_launch_counts_add_back():
    before = ops.launch_counts()
    delta = {("decode_attention", None): 2, ("decode_attention", "split"): 2,
             ("moe_gmm", "stream"): 3}
    ops.add_launches(delta, 3)
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        k: 3 * n for k, n in delta.items()}
    ops.add_launches(delta, -3)
    assert ops.launch_counts() == before


def test_a_graph_needs_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        DecodeGraph(lambda tok, pos: tok, torch.zeros((B, 1), dtype=torch.long), 3)


def test_engine_decode_modes():
    cfg = dataclasses.replace(reduced(get_arch("qwen3-1.7b")), dtype="float32")
    with pytest.raises(ValueError, match="decode"):
        ServingEngine(cfg, device="cpu", decode="jit")
    eng = ServingEngine(cfg, batch_slots=B, max_seq_len=24, device="cpu", decode="eager")
    prompts = [[1, 2, 3], [4, 5, 6]]
    assert eng.generate(prompts, 4) == ServingEngine(
        cfg, batch_slots=B, max_seq_len=24, device="cpu").generate(prompts, 4)
