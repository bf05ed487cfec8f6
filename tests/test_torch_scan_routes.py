"""The two designs of each scan kernel, on the CPU: which design a call
takes (``route``), the launch geometry of the new designs (every state value
owned by exactly one thread, the chunks cover the time axis, shared memory
fits), the route counts, and the arithmetic the new designs reassociate,
written in plain torch and held against the JAX package.

``mamba_scan``'s ``lanes`` design takes its exponential as ex2.approx of
dt * A * log2(e); ``rwkv6_scan``'s ``cols`` design takes o_j = sum_i r_i
S[i, j] + v_j * sum_i r_i u_i k_i, the first sum in slices of 8 rows.
Both forms are held here over 512 steps, the serving prefill's length,
against JAX's Pallas kernels (interpret mode, as ``tests/test_kernels.py``
runs them) and oracles at the scans' limit there, atol = rtol = 2e-4.  The
kernels themselves run only on the card (``tests/test_torch_gpu.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.mamba_scan import mamba_scan as pallas_mamba_scan  # noqa: E402
from repro.kernels.rwkv6_scan import rwkv6_scan as pallas_rwkv6_scan  # noqa: E402
from repro_torch.kernels import mamba_scan as tmamba  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rwkv6_scan as trwkv  # noqa: E402

SCAN_TOL = dict(atol=2e-4, rtol=2e-4)
STATIC_SMEM = 48 * 1024      # static shared memory a block may declare
LOG2E = 1.4426950408889634
EX2_ERROR = 2.0 ** -21       # four ulps of a factor near 1


# -- routes ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ds", range(1, 17))
def test_mamba_route(dtype, ds):
    assert tmamba.route(dtype, ds) == ("lanes" if ds % 4 == 0 else "simt")


@pytest.mark.parametrize("ds", [0, 17, 20])
def test_mamba_route_past_the_state_limit_is_simt(ds):
    """ds the kernels do not take goes to simt, whose checks refuse it."""
    assert tmamba.route(torch.float32, ds) == "simt"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [8, 16, 24, 32, 48, 64, 128])
def test_rwkv6_route(dtype, hd):
    assert trwkv.route(dtype, hd) == ("cols" if hd in (16, 32, 64) else "simt")


def test_routes_of_other_dtypes_are_simt():
    assert tmamba.route(torch.float16, 16) == "simt"
    assert trwkv.route(torch.float16, 64) == "simt"


def test_scan_route_counts_ignore_cpu_tensors():
    ops.reset_launches()
    g = torch.Generator().manual_seed(0)
    B, S, di, ds = 2, 5, 8, 16
    ops.mamba_scan(torch.rand((B, S, di), generator=g), torch.rand((B, S, di), generator=g),
                   torch.rand((B, S, ds), generator=g), torch.rand((B, S, ds), generator=g),
                   -torch.rand((di, ds), generator=g))
    r, k, v, w = (torch.rand((1, 3, 2, 16), generator=g) for _ in range(4))
    ops.rwkv6_scan(r, k, v, w, torch.rand((2, 16), generator=g))
    assert ops.ROUTE_LAUNCHES["mamba_scan"] == {"lanes": 0, "simt": 0}
    assert ops.ROUTE_LAUNCHES["rwkv6_scan"] == {"cols": 0, "simt": 0}
    assert ops.LAUNCHES["mamba_scan"] == ops.LAUNCHES["rwkv6_scan"] == 0


def test_scan_entry_points_refuse_cpu_tensors():
    """Both designs' entry points raise on CPU tensors before any build or
    launch: they never fall back to the plain version."""
    before = dict(tmamba.LAUNCHES), dict(trwkv.LAUNCHES)
    dt = torch.zeros((1, 4, 64))
    bc, A = torch.zeros((1, 4, 16)), torch.zeros((64, 16))
    for fn in (tmamba.mamba_scan, tmamba.mamba_scan_simt):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(dt, dt, bc, bc, A)
    r = torch.zeros((1, 4, 2, 64))
    for fn in (trwkv.rwkv6_scan, trwkv.rwkv6_scan_simt):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(r, r, r, r, torch.zeros((2, 64)))
    assert (tmamba.LAUNCHES, trwkv.LAUNCHES) == before


# -- launch geometry ------------------------------------------------------------

@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("B,S,di,ds", [
    (3, 77, 333, 16),      # ragged di and S (tests/test_kernels.py's tail case)
    (1, 1, 64, 4),         # one step, half a tile
    (2, 33, 70, 8),
    (2, 17, 130, 12),      # ds 12: the fourth lane of each group holds nothing
    (1, 8, 1, 16),         # one channel
    (8, 512, 8192, 16),    # jamba-v0.1-52b's prefill
    (8, 1, 8192, 16),      # and its decode step
])
def test_mamba_lanes_geometry_owns_every_state_once(B, S, di, ds, itemsize):
    g = tmamba.lanes_geometry(B, S, di, ds, itemsize)
    assert g.lanes == {4: 1, 8: 2, 12: 4, 16: 4}[ds]
    assert g.block == tmamba.LANES_TILE // tmamba.LANES_GROUP * g.lanes
    assert g.block % 32 == 0 and 32 % g.lanes == 0     # a group's lanes share a warp
    assert g.grid == (-(-di // tmamba.LANES_TILE), B)
    assert (g.chunks - 1) * tmamba.LANES_CHUNK < S <= g.chunks * tmamba.LANES_CHUNK
    owned = np.zeros((di, ds), np.int64)
    for bx in range(g.grid[0]):
        for tid in range(g.block):
            channels, states = tmamba.lanes_owner(g, bx, tid)
            for c in channels:
                for n in states:
                    if c < di and n < ds:
                        owned[c, n] += 1
    assert (owned == 1).all()      # the same for each of the grid's B rows
    assert g.smem <= min(tmamba.SMEM_LIMIT, STATIC_SMEM)


@pytest.mark.parametrize("B", [1, 8, 4097, 65535])
def test_mamba_lanes_geometry_takes_any_batch(B):
    """gridDim.y is the batch row: every B that check_inputs takes fits."""
    for di in (1, 127, 128, 129, 8192, 333):
        g = tmamba.lanes_geometry(B, 5, di, 16, 4)
        assert g.grid[1] == B <= 65535 and g.grid[0] * tmamba.LANES_TILE >= di


def test_mamba_lanes_geometry_refuses_other_state_sizes():
    for ds in (3, 6, 15, 20):
        with pytest.raises(ValueError, match="lanes design"):
            tmamba.lanes_geometry(1, 1, 64, ds, 4)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("B,T,H,hd", [
    (1, 70, 3, 32),        # ragged T (tests/test_torch_gpu.py's tail case)
    (2, 96, 1, 16),
    (3, 1, 4, 64),         # one step from a state
    (8, 512, 32, 64),      # rwkv6-1.6b's prefill
])
def test_rwkv6_cols_geometry_owns_every_state_once(B, T, H, hd, itemsize):
    g = trwkv.cols_geometry(B, T, H, hd, itemsize)
    assert g.slices * trwkv.COLS_ROWS == hd
    assert g.block == g.slices * hd // g.columns and g.block % 32 == 0
    assert g.grid == B * H < 2 ** 31
    assert (g.chunks - 1) * trwkv.COLS_CHUNK < T <= g.chunks * trwkv.COLS_CHUNK
    owned = np.zeros((hd, hd), np.int64)     # (i, j) of one (batch row, head)
    for tid in range(g.block):
        cols, rows = trwkv.cols_owner(g, hd, tid)
        for i in rows:
            for j in cols:
                owned[i, j] += 1
    assert (owned == 1).all()
    assert 2 * (g.smem + 1024) <= 228 * 1024 <= trwkv.SMEM_LIMIT + 1024  # two blocks an SM


@pytest.mark.parametrize("hd", [16, 32, 64])
def test_rwkv6_cols_warps_share_their_rows(hd):
    """The threads of a warp hold the same rows (two slices at hd = 16), so
    their shared loads of r, k and w are broadcasts, and neighbouring
    threads hold neighbouring columns, so their loads of the state are
    whole runs."""
    g = trwkv.cols_geometry(1, 1, 1, hd, 4)
    for warp in range(g.block // 32):
        owners = [trwkv.cols_owner(g, hd, 32 * warp + lane) for lane in range(32)]
        assert len({rows for _, rows in owners}) == (2 if hd == 16 else 1)
        starts = [cols[0] for cols, _ in owners]
        assert all(b - a in (g.columns, -hd + g.columns) for a, b in zip(starts, starts[1:]))


@pytest.mark.parametrize("B,H", [(65535, 32), (8, 32), (1, 1)])
def test_rwkv6_cols_geometry_takes_any_batch(B, H):
    """The grid is batch rows x heads, below 2**31 by check_inputs."""
    for hd in (16, 32, 64):
        assert trwkv.cols_geometry(B, 3, H, hd, 2).grid == B * H < 2 ** 31


# -- the reassociated arithmetic, held against JAX --------------------------------

def _mamba_inputs(B, S, di, ds, seed):
    """Scan terms at the scales of tests/test_kernels.py."""
    rng = np.random.default_rng(seed)
    dt = (np.log1p(np.exp(rng.standard_normal((B, S, di)))) * 0.1).astype(np.float32)
    dtx = (rng.standard_normal((B, S, di)) * 0.1).astype(np.float32)
    Bm = rng.standard_normal((B, S, ds)).astype(np.float32)
    Cm = rng.standard_normal((B, S, ds)).astype(np.float32)
    A = (-np.exp(rng.standard_normal((di, ds)))).astype(np.float32)
    h0 = rng.standard_normal((B, di, ds)).astype(np.float32)
    return dt, dtx, Bm, Cm, A, h0


def _mamba_ex2(dt, dtx, Bm, Cm, A, h0, bias):
    """The lanes design's recurrence in fp32: each factor is 2^(dt * A')
    with A' = A * log2(e) prescaled once, off by a relative ``bias``."""
    dt, dtx, Bm, Cm, A = (torch.from_numpy(x) for x in (dt, dtx, Bm, Cm, A))
    a = A * torch.tensor(LOG2E, dtype=torch.float32)
    h = torch.zeros(dt.shape[0], *A.shape) if h0 is None else torch.from_numpy(h0).clone()
    ys = []
    for t in range(dt.shape[1]):
        decay = torch.exp2(dt[:, t, :, None] * a) * (1 + bias)
        h = decay * h + dtx[:, t, :, None] * Bm[:, t, None, :]
        ys.append((h * Cm[:, t, None, :]).sum(-1))
    return torch.stack(ys, 1).numpy(), h.numpy()


@pytest.mark.parametrize("bias", [EX2_ERROR, -EX2_ERROR])
def test_mamba_ex2_form_against_pallas_over_512_steps(bias):
    """ex2.approx's error, taken all of one sign at every step, stays
    inside the scans' 2e-4 over the serving prefill's 512 steps."""
    dt, dtx, Bm, Cm, A, _ = _mamba_inputs(2, 512, 64, 16, seed=1)
    y, h = pallas_mamba_scan(*(jnp.asarray(x) for x in (dt, dtx, Bm, Cm, A)),
                             block_d=64, block_s=256, interpret=True)
    ty, th = _mamba_ex2(dt, dtx, Bm, Cm, A, None, bias)
    np.testing.assert_allclose(ty, np.asarray(y), **SCAN_TOL)
    np.testing.assert_allclose(th, np.asarray(h), **SCAN_TOL)


def test_mamba_ex2_form_against_the_oracle_from_a_state():
    dt, dtx, Bm, Cm, A, h0 = _mamba_inputs(2, 512, 48, 12, seed=2)
    y, h = jref.mamba_scan_ref(*(jnp.asarray(x) for x in (dt, dtx, Bm, Cm, A, h0)))
    ty, th = _mamba_ex2(dt, dtx, Bm, Cm, A, h0, EX2_ERROR)
    np.testing.assert_allclose(ty, np.asarray(y), **SCAN_TOL)
    np.testing.assert_allclose(th, np.asarray(h), **SCAN_TOL)


def _wkv_inputs(B, T, H, hd, seed):
    """r, k, v, w, u and a state at the scales of tests/test_kernels.py."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    k = (rng.standard_normal((B, T, H, hd)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((B, T, H, hd)) * 0.3).astype(np.float32)
    w = (1 / (1 + np.exp(-(rng.standard_normal((B, T, H, hd)) * 0.5 + 2)))).astype(np.float32)
    u = (rng.standard_normal((H, hd)) * 0.1).astype(np.float32)
    S0 = (rng.standard_normal((B, H, hd, hd)) * 0.3).astype(np.float32)
    return r, k, v, w, u, S0


def _wkv_cols(r, k, v, w, u, S0):
    """The cols design's arithmetic in fp32: per step, the parts of sum_i
    r_i S[i, j] over each slice of 8 rows, summed after v_j * sum_i (r_i
    u_i) k_i; then S[i, j] <- w_i S[i, j] + k_i v_j."""
    r, k, v, w, u = (torch.from_numpy(x) for x in (r, k, v, w, u))
    B, T, H, hd = r.shape
    S = torch.zeros(B, H, hd, hd) if S0 is None else torch.from_numpy(S0).clone()
    slices = hd // trwkv.COLS_ROWS
    outs = []
    for t in range(T):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]           # (B, H, hd)
        parts = torch.einsum("bhsi,bhsij->sbhj", rt.reshape(B, H, slices, -1),
                             S.reshape(B, H, slices, -1, hd))
        o = vt * (rt * u * kt).sum(-1, keepdim=True)
        for p in parts:
            o = o + p
        outs.append(o)
        S = wt[..., None] * S + kt[..., None] * vt[..., None, :]
    return torch.stack(outs, 1).numpy(), S.numpy()


@pytest.mark.parametrize("hd", [64, 32, 16])
def test_rwkv6_cols_form_against_pallas_over_512_steps(hd):
    r, k, v, w, u, _ = _wkv_inputs(1, 512, 2, hd, seed=3)
    o, S = pallas_rwkv6_scan(*(jnp.asarray(x) for x in (r, k, v, w, u)), block_t=256,
                             interpret=True)
    to, tS = _wkv_cols(r, k, v, w, u, None)
    np.testing.assert_allclose(to, np.asarray(o), **SCAN_TOL)
    np.testing.assert_allclose(tS, np.asarray(S), **SCAN_TOL)


def test_rwkv6_cols_form_against_the_oracle_from_a_state():
    r, k, v, w, u, S0 = _wkv_inputs(2, 512, 2, 64, seed=4)
    o, S = jref.rwkv6_scan_ref(*(jnp.asarray(x) for x in (r, k, v, w, u, S0)))
    to, tS = _wkv_cols(r, k, v, w, u, S0)
    np.testing.assert_allclose(to, np.asarray(o), **SCAN_TOL)
    np.testing.assert_allclose(tS, np.asarray(S), **SCAN_TOL)
