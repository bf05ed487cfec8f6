"""The port's chunked linear scan (``repro_torch.models.scan_utils``) against
the JAX package's on the cases of ``tests/test_models.py``'s chunked-scan
property (T in 8..128, chunks of 4..64, sigmoid decays and 0.3-scaled
inputs on a (4, 3) state): the states, the last state and the emitted
outputs, the sequential oracle, the chunk count and the gradients, in fp32
at atol = rtol = 1e-5, the JAX test's limit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import scan_utils as jscan  # noqa: E402
from repro_torch.models import scan_utils as tscan  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
TS = (8, 16, 32, 64, 128)
CHUNKS = (4, 8, 16, 32, 64)


def _inputs(T, seed):
    rng = np.random.default_rng(seed)
    a = (1 / (1 + np.exp(-rng.standard_normal((T, 4, 3))))).astype(np.float32)
    b = (rng.standard_normal((T, 4, 3)) * 0.3).astype(np.float32)
    h0 = rng.standard_normal((4, 3)).astype(np.float32)
    return a, b, h0


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("T", TS)
def test_chunked_scan_matches_jax(T, chunk):
    a, b, h0 = _inputs(T, seed=T * 100 + chunk)

    def make_ab(cin):
        return cin["a"], cin["b"]

    def emit(h_prev, h_post, cin):      # both states reach the output
        return h_post + 0.5 * h_prev

    ys, h_last = tscan.linear_scan_emit({"a": torch.from_numpy(a), "b": torch.from_numpy(b)},
                                        torch.from_numpy(h0), make_ab, emit, chunk=chunk)
    jys, jh = jscan.linear_scan_emit({"a": jnp.asarray(a), "b": jnp.asarray(b)},
                                     jnp.asarray(h0), make_ab, emit, chunk=chunk)
    np.testing.assert_allclose(ys.numpy(), np.array(jys), **TOL)
    np.testing.assert_allclose(h_last.numpy(), np.array(jh), **TOL)
    hs, h_ref = tscan.linear_scan_ref(*map(torch.from_numpy, (a, b, h0)))
    jhs, jh_ref = jscan.linear_scan_ref(*map(jnp.asarray, (a, b, h0)))
    np.testing.assert_allclose(hs.numpy(), np.array(jhs), **TOL)
    np.testing.assert_allclose(h_ref.numpy(), np.array(jh_ref), **TOL)
    assert tscan.scan_chunk_count(T, chunk) == jscan.scan_chunk_count(T, chunk)


def test_chunked_scan_gradients_match_jax():
    a, b, h0 = _inputs(64, seed=1)
    g = np.random.default_rng(2).standard_normal((64, 4, 3)).astype(np.float32)

    def j_loss(a, b, h0):
        ys, h = jscan.linear_scan_emit((a, b), h0, lambda c: c, lambda hp, hq, c: hq, chunk=16)
        return (ys * g).sum() + h.sum()

    expect = jax.grad(j_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (a, b, h0)))
    ta, tb, th = (torch.from_numpy(x).requires_grad_(True) for x in (a, b, h0))
    ys, h = tscan.linear_scan_emit((ta, tb), th, lambda c: c, lambda hp, hq, c: hq, chunk=16)
    got = torch.autograd.grad((ys * torch.from_numpy(g)).sum() + h.sum(), (ta, tb, th))
    for x, e in zip(got, expect):
        np.testing.assert_allclose(x.numpy(), np.array(e), atol=1e-4, rtol=1e-4)


def test_a_length_the_chunks_do_not_divide_is_refused():
    a, b, h0 = (torch.from_numpy(x) for x in _inputs(24, seed=0))
    with pytest.raises(ValueError, match="not divisible"):
        tscan.linear_scan_emit((a, b), h0, lambda c: c, lambda hp, hq, c: hq, chunk=16)
