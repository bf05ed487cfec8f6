"""The port's serving substrate on the CPU: the paged KV manager and the
continuous batcher (counterparts of ``tests/test_serving.py``), sampling,
and the port's ``ServingEngine`` against the JAX engine with the same
weights."""
import dataclasses

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")

from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.config import reduced as jax_reduced  # noqa: E402
from repro.serving import PagedKVManager as JaxKV  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.train.checkpoint import _flatten  # noqa: E402
from repro_torch.config import get_arch, reduced  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import (ContinuousBatcher, PagedKVManager,  # noqa: E402
                                 ServingEngine)
from repro_torch.serving.sampling import sample  # noqa: E402


def _cfg(**kw):
    return dataclasses.replace(reduced(get_arch("qwen3-1.7b")), **{"dtype": "float32", **kw})


def _jax_cfg(**kw):
    return dataclasses.replace(jax_reduced(jax_get_arch("qwen3-1.7b")),
                               **{"dtype": "float32", **kw})


# ---------------------------------------------------------------------------
def test_kv_admit_release_cycle():
    kv = PagedKVManager(_cfg(), n_slots=2, max_seq_len=64)
    a = kv.admit()
    b = kv.admit()
    assert not kv.can_admit()
    with pytest.raises(RuntimeError):
        kv.admit()
    kv.release(a.seq_id)
    c = kv.admit()
    assert c.slot == a.slot          # slot reuse
    kv.release(b.seq_id)
    kv.release(c.seq_id)
    assert kv.used_pages == 0


@settings(max_examples=60, deadline=None)
@given(ops=st.lists(st.tuples(st.sampled_from(["admit", "release", "advance"]),
                              st.integers(0, 7)), max_size=60))
def test_property_kv_slots_never_leak(ops):
    kv = PagedKVManager(_cfg(), n_slots=4, max_seq_len=128)
    live = {}
    for op, arg in ops:
        if op == "admit" and kv.can_admit():
            st_ = kv.admit()
            live[st_.seq_id] = st_
        elif op == "release" and live:
            sid = sorted(live)[arg % len(live)]
            kv.release(sid)
            del live[sid]
        elif op == "advance" and live:
            sid = sorted(live)[arg % len(live)]
            if live[sid].length < 120:
                kv.advance(sid, 8)
        assert len(kv.free_slots) + len(kv.seqs) == 4
        assert 0 <= kv.used_pages <= kv.total_pages
    assert set(kv.seqs) == set(live)


@pytest.mark.parametrize("window,dtype,max_seq_len", [
    (None, "float32", 64), (8, "float32", 64), (None, "bfloat16", 300),
])
def test_kv_accounting_matches_jax(window, dtype, max_seq_len):
    t = PagedKVManager(_cfg(sliding_window=window, dtype=dtype), 3, max_seq_len)
    j = JaxKV(_jax_cfg(sliding_window=window, dtype=dtype), 3, max_seq_len)
    assert (t.pages_per_slot, t.total_pages, t.bytes_per_slot()) == \
        (j.pages_per_slot, j.total_pages, j.bytes_per_slot())
    for kv in (t, j):
        s = kv.admit()
        kv.advance(s.seq_id, 130 if max_seq_len > 130 else 20)
    assert t.used_pages == j.used_pages and t.utilization() == j.utilization()


def test_batcher_lifecycle():
    kv = PagedKVManager(_cfg(), n_slots=2, max_seq_len=64)
    b = ContinuousBatcher(kv, max_batch=2)
    r1 = b.submit([1, 2, 3], max_new_tokens=2)
    r2 = b.submit([4, 5, 6], max_new_tokens=1)
    r3 = b.submit([7, 8, 9], max_new_tokens=1)
    admitted = b.admit_ready()
    assert len(admitted) == 2 and len(b.waiting) == 1
    slots = b.active_slots
    b.record_token(slots[1], 11)     # r2 done after 1 token
    assert r2.done and r2.generated == [11]
    assert len(b.admit_ready()) == 1  # r3 takes the freed slot
    b.record_token(slots[0], 21)
    b.record_token(slots[0], 22)
    assert r1.done and r1.generated == [21, 22]
    for s in list(b.running):
        b.record_token(s, 31)
    assert r3.done
    assert not b.has_work()


# ---------------------------------------------------------------------------
def test_greedy_sample_is_argmax_first_of_ties():
    logits = torch.tensor([[[0.0, 3.0, 3.0, 1.0]], [[5.0, -1.0, 5.0, 0.0]]])
    assert sample(logits, None, 0.0).tolist() == [1, 0]


def test_temperature_sample_follows_softmax():
    logits = torch.log(torch.tensor([[0.1, 0.2, 0.7]])).repeat(4000, 1)
    gen = torch.Generator().manual_seed(0)
    toks = sample(logits, gen, temperature=1.0)
    freq = np.bincount(toks.numpy(), minlength=3) / len(toks)
    np.testing.assert_allclose(freq, [0.1, 0.2, 0.7], atol=0.03)
    top1 = sample(logits[:10], gen, temperature=1.0, top_k=1)
    assert top1.tolist() == [2] * 10


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_kv_heads", [None, 2])
def test_engine_greedy_tokens_match_jax(n_kv_heads):
    kw = {} if n_kv_heads is None else {"n_kv_heads": n_kv_heads}
    jeng = JaxEngine(_jax_cfg(**kw), batch_slots=2, max_seq_len=32, seed=3)
    params = params_from_jax(_flatten(jeng.params), device="cpu")
    teng = ServingEngine(_cfg(**kw), batch_slots=2, max_seq_len=32, device="cpu",
                         params=params)
    p = [[1, 2, 3, 4], [9, 8, 7, 6]]
    assert teng.generate(p, max_new_tokens=6) == jeng.generate(p, max_new_tokens=6)
    assert len(teng.step_times_s) == 6          # one prefill, five decode steps
    assert teng.mean_decode_step_us() > 0


def test_engine_generates_deterministic_greedy():
    eng1 = ServingEngine(_cfg(), batch_slots=2, max_seq_len=32, seed=3, device="cpu")
    eng2 = ServingEngine(_cfg(), batch_slots=2, max_seq_len=32, seed=3, device="cpu")
    p = [[1, 2, 3, 4], [9, 8, 7, 6]]
    assert eng1.generate(p, max_new_tokens=5) == eng2.generate(p, max_new_tokens=5)


def test_engine_refuses_unequal_prompts():
    eng = ServingEngine(_cfg(), batch_slots=2, max_seq_len=32, device="cpu")
    with pytest.raises(ValueError, match="equal prompt lengths"):
        eng.generate([[1, 2, 3], [4, 5]], max_new_tokens=2)


def test_engine_on_cuda_without_a_card_raises(monkeypatch):
    """The default device is the card; asking for it without one raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(_cfg(), batch_slots=2, max_seq_len=32)


def test_launcher_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--batch-slots", "2", "--max-new-tokens", "3"])
    out = capsys.readouterr().out
    assert "measured prefill" in out and "decode step" in out


@pytest.mark.parametrize("backend", ["containerd", "junctiond"])
def test_launcher_runs_the_faas_half(backend, capsys):
    """The measured decode step is deployed on the backend and driven with
    ``--requests`` sequential invocations through the simulated runtime."""
    from repro_torch.launch import serve
    summary = serve.main(["--device", "cpu", "--backend", backend, "--requests", "5",
                          "--batch-slots", "2", "--max-new-tokens", "3"])
    out = capsys.readouterr().out
    assert f"behind {backend}" in out
    assert f"5 invocations through the {backend} runtime (simulated): median=" in out
    assert "FaaS runtime overhead at median" in out
    assert summary.n == 5 and summary.median_ms <= summary.p99_ms


def test_launcher_refuses_a_backend_not_ported():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--backend", "quark"])
