"""The CUDA kernels against their plain versions on the card.

Marked ``gpu``; each test skips with a reason where there is no card.  Run
on a machine with one:  ``pytest -m gpu tests/test_torch_gpu.py``.  The
sweep is that of ``tests/test_kernels.py`` plus the serving path's shapes.
Kernels and plain versions both compute in fp32 and round once, so fp32 is
held at atol = rtol = 3e-5 (the MoE matmul, whose sums run over up to 14336
terms, at the fp32 limit of ``tests/test_kernels.py``, atol 2e-3 / rtol
2e-4) and bf16 at atol 1e-3, rtol 1e-2 (one bf16 ulp is at most 2**-7 of
|x|).  The two scans carry an fp32 state through every step, so fp32 is
held at their limit in ``tests/test_kernels.py``, atol = rtol = 2e-4.
AES-128-CTR is integer arithmetic and is held bit-exact.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as tdecode  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import mamba_scan as tmamba  # noqa: E402
from repro_torch.kernels import moe_gmm as tgmm  # noqa: E402
from repro_torch.kernels import rwkv6_scan as trwkv  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

pytestmark = pytest.mark.gpu

TOL = {"float32": (3e-5, 3e-5), "bfloat16": (1e-3, 1e-2)}   # (atol, rtol)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _assert_close(out, expect, dtype):
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), expect.float(), atol=atol, rtol=rtol)


def _assert_close_at(out, expect, tol):
    torch.testing.assert_close(out.float(), expect.float(), atol=tol[0], rtol=tol[1])


def _assert_sum_close(out, expect, rel=1e-4):
    """A gradient that sums over channels, batch rows or time, held at
    ``rel`` of its largest magnitude."""
    scale = float(expect.float().abs().max())
    torch.testing.assert_close(out.float(), expect.float(), atol=rel * scale, rtol=0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,S,T,d,causal,win", [
    (2, 4, 2, 128, 128, 64, True, None),
    (1, 8, 2, 96, 96, 64, True, 32),
    (2, 2, 2, 64, 192, 32, True, None),
    (1, 4, 4, 128, 128, 128, False, None),
    (1, 2, 1, 257, 257, 64, True, None),
    (1, 4, 2, 70, 40, 32, True, None),      # S > T: rows with no allowed key
    (8, 16, 8, 512, 512, 128, True, None),  # the prefill of the serving path
])
def test_flash_attention_kernel(cuda, B, Hq, Hkv, S, T, d, causal, win, dtype):
    dt = getattr(torch, dtype)
    q = _randn(cuda, (B, Hq, S, d), dt)
    k, v = _randn(cuda, (B, Hkv, T, d), dt), _randn(cuda, (B, Hkv, T, d), dt)
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    _assert_close(out, ref.flash_attention_ref(q, k, v, causal=causal, window=win), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,T,d", [
    (2, 8, 2, 300, 64), (1, 4, 4, 512, 128), (3, 16, 8, 257, 64),
    (8, 16, 8, 1024, 128),                  # a decode step of the serving path
])
def test_decode_attention_kernel(cuda, B, Hq, Hkv, T, d, dtype):
    dt = getattr(torch, dtype)
    q = _randn(cuda, (B, Hq, d), dt)
    k, v = _randn(cuda, (B, T, Hkv, d), dt), _randn(cuda, (B, T, Hkv, d), dt)
    valid = torch.rand((B, T), generator=cuda, device="cuda") < 0.8
    valid[:, 0] = True
    valid[-1] = False                       # a row with no valid slot
    before = ops.LAUNCHES["decode_attention"]
    out = ops.decode_attention(q, k, v, valid.int())
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention"] == before + 1
    _assert_close(out, ref.decode_attention_ref(q, k, v, valid), dtype)


FLASH_SWEEP = [   # tests/test_kernels.py
    (2, 4, 2, 128, 128, 64, True, None), (1, 8, 2, 96, 96, 64, True, 32),
    (2, 2, 2, 64, 192, 32, True, None), (1, 4, 4, 128, 128, 128, False, None),
    (1, 2, 1, 257, 257, 64, True, None),
]
FLASH_MAIN = (8, 16, 8, 512, 512, 128, True, None)   # the prefill of the serving path


@pytest.mark.parametrize("B,Hq,Hkv,S,T,d,causal,win", FLASH_SWEEP + [
    (1, 4, 2, 512, 512, 128, True, None),   # G = 2 at the serving length
    (1, 4, 2, 200, 700, 128, True, None),   # ragged S in a longer T: a prefix offset
    (1, 4, 2, 70, 40, 32, True, None),      # S > T: rows with no allowed key
    (2, 24, 8, 512, 512, 128, True, None),  # phi4-mini-3.8b's G = 3
    (1, 64, 8, 512, 512, 128, True, None),  # deepseek-67b's G = 8 at d 128
])
@pytest.mark.parametrize("which", ["wgmma", "simt"])
def test_flash_attention_routes_in_bf16(cuda, B, Hq, Hkv, S, T, d, causal, win, which):
    """Each design in bf16 against the plain version: the wgmma one through
    the routed entry point, the simt one through its own."""
    q = _randn(cuda, (B, Hq, S, d), torch.bfloat16)
    k, v = (_randn(cuda, (B, Hkv, T, d), torch.bfloat16) for _ in range(2))
    fn = tflash.flash_attention if which == "wgmma" else tflash.flash_attention_simt
    before = dict(tflash.LAUNCHES)
    out = fn(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert tflash.LAUNCHES[which] == before[which] + 1
    _assert_close(out, ref.flash_attention_ref(q, k, v, causal=causal, window=win), "bfloat16")


def test_flash_attention_routes_agree_at_the_serving_shape(cuda):
    B, Hq, Hkv, S, T, d, causal, win = FLASH_MAIN
    q = _randn(cuda, (B, Hq, S, d), torch.bfloat16)
    k, v = (_randn(cuda, (B, Hkv, T, d), torch.bfloat16) for _ in range(2))
    new = tflash.flash_attention(q, k, v)
    old = tflash.flash_attention_simt(q, k, v)
    _assert_close(new, old, "bfloat16")


def test_kernel_refuses_strided_operands(cuda):
    q = _randn(cuda, (1, 4, 64, 64), torch.float32)
    k = _randn(cuda, (1, 2, 64, 64), torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(2, 3), k, k)


# ---------------------------------------------------------------------------
# MoE expert matmul: fp32 at the limit of tests/test_kernels.py (atol 2e-3,
# rtol 2e-4); bf16 at one ulp, as above


GMM_TOL = {"float32": (2e-3, 2e-4), "bfloat16": TOL["bfloat16"]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,D,F", [
    (4, 100, 96, 130), (2, 64, 256, 64), (8, 33, 48, 72),   # tests/test_kernels.py
    (3, 70, 40, 36),                        # D and F not multiples of 8: scalar loads
])
def test_moe_gmm_kernel(cuda, E, C, D, F, dtype):
    _check_moe_gmm(cuda, (E, C, D), (E, D, F), dtype)


@pytest.mark.parametrize("E,C,D,F", [
    (8, 2, 4096, 14336),                    # mixtral-8x7b decode, gate and up
    (8, 2, 14336, 4096),                    # mixtral-8x7b decode, down
    (8, 1280, 4096, 14336),                 # prefill of 8 x 512 tokens, gate and up
    (8, 1280, 14336, 4096),                 # prefill, down
])
def test_moe_gmm_kernel_at_the_serving_shapes(cuda, E, C, D, F):
    """bf16, with weights at the model's scale, N(0, 1/D) as ``dense_init``
    draws them, so that |y| is of the order of the partial sums and the
    fp32 sums of both versions stay far inside one bf16 ulp of |y|."""
    _check_moe_gmm(cuda, (E, C, D), (E, D, F), "bfloat16", w_scale=D ** -0.5)


def _check_moe_gmm(cuda, xs, ws, dtype, w_scale=1.0):
    dt = getattr(torch, dtype)
    x, w = _randn(cuda, xs, dt), (_randn(cuda, ws, torch.float32) * w_scale).to(dt)
    E, C, F = xs[0], xs[1], ws[2]
    before = ops.LAUNCHES["moe_gmm"]
    out = ops.moe_gmm(x, w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["moe_gmm"] == before + 1
    assert out.dtype == dt and out.shape == (E, C, F)
    atol, rtol = GMM_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.moe_gmm_ref(x, w).float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("E,C,D,F", [
    (8, 1280, 4096, 14336),                 # mixtral prefill, gate and up
    (16, 640, 14336, 4096),                 # jamba prefill, down
    (4, 200, 4096, 14336),                  # a C tail
    (2, 64, 4096, 4096),                    # C at the threshold
    (3, 200, 96, 72),                       # tails of C, D (K) and F
    (2, 640, 96, 14336),                    # a D tail at the serving F
    (1, 1280, 4096, 72),                    # one expert, an F tail
])
def test_moe_gmm_wgmma_route(cuda, E, C, D, F):
    """The wgmma design against the plain version in bf16, weights at the
    model's scale as above."""
    assert tgmm.route(torch.bfloat16, C, D, F) == "wgmma"
    before = dict(tgmm.LAUNCHES)
    _check_moe_gmm(cuda, (E, C, D), (E, D, F), "bfloat16", w_scale=D ** -0.5)
    assert tgmm.LAUNCHES == {**before, "wgmma": before["wgmma"] + 1}


@pytest.mark.parametrize("E,C,D,F", [
    (8, 1280, 4096, 14336), (8, 1280, 14336, 4096),     # mixtral prefill
    (16, 640, 4096, 14336), (16, 640, 14336, 4096),     # jamba prefill
])
def test_moe_gmm_routes_agree_at_the_serving_shapes(cuda, E, C, D, F):
    """The two designs on the same bf16 operands: the wgmma one through the
    routed entry point, the mma_sync one through its own; both sum in fp32
    and round once."""
    x = _randn(cuda, (E, C, D), torch.bfloat16)
    w = (_randn(cuda, (E, D, F), torch.float32) * D ** -0.5).bfloat16()
    before = dict(tgmm.LAUNCHES)
    new, old = tgmm.moe_gmm(x, w), tgmm.moe_gmm_mma_sync(x, w)
    assert tgmm.LAUNCHES == {**before, "wgmma": before["wgmma"] + 1,
                             "mma_sync": before["mma_sync"] + 1}
    atol, rtol = TOL["bfloat16"]
    torch.testing.assert_close(new.float(), old.float(), atol=atol, rtol=rtol)


def test_moe_gmm_kernel_on_an_empty_output(cuda):
    before = ops.LAUNCHES["moe_gmm"]
    out = ops.moe_gmm(_randn(cuda, (2, 0, 8), torch.float32),
                      _randn(cuda, (2, 8, 4), torch.float32))
    assert out.shape == (2, 0, 4) and ops.LAUNCHES["moe_gmm"] == before


@pytest.mark.parametrize("case", ["dtype", "strided", "experts", "depth"])
def test_moe_gmm_kernel_refuses_bad_operands(cuda, case):
    from repro_torch.kernels.moe_gmm import moe_gmm
    x, w = _randn(cuda, (2, 16, 32), torch.float32), _randn(cuda, (2, 32, 24), torch.float32)
    if case == "dtype":
        x, w = x.half(), w.half()
    elif case == "strided":
        x = _randn(cuda, (2, 32, 32), torch.float32)[:, ::2]
    elif case == "experts":
        w = _randn(cuda, (3, 32, 24), torch.float32)
    else:
        w = _randn(cuda, (2, 40, 24), torch.float32)
    with pytest.raises(ValueError, match="moe_gmm"):
        moe_gmm(x, w)


@pytest.mark.parametrize("E,C,D,F", [
    (16, 1, 4096, 14336),                   # jamba-v0.1-52b decode, gate and up
    (16, 1, 14336, 4096),                   # jamba decode, down
    (16, 640, 4096, 14336),                 # jamba prefill of 8 x 512 tokens, gate and up
    (16, 640, 14336, 4096),                 # jamba prefill, down
])
def test_moe_gmm_kernel_at_jambas_serving_shapes(cuda, E, C, D, F):
    _check_moe_gmm(cuda, (E, C, D), (E, D, F), "bfloat16", w_scale=D ** -0.5)


PHI35_GMM = [   # E, C, D, F of phi3.5-moe-42b-a6.6b at 8 x 512 tokens
    (16, 1, 4096, 6400),                    # decode, gate and up
    (16, 1, 6400, 4096),                    # decode, down: 6400 is the contraction
    (16, 640, 4096, 6400),                  # prefill and training, gate and up
    (16, 640, 6400, 4096),                  # prefill and training, down
]


@pytest.mark.parametrize("E,C,D,F", PHI35_GMM)
def test_moe_gmm_kernel_at_phi35s_shapes(cuda, E, C, D, F):
    """The forward at phi3.5-moe's expert widths on its route (``stream``
    at C 1, ``wgmma`` at C 640), bf16, weights at the model's scale."""
    route = tgmm.route(torch.bfloat16, C, D, F)
    assert route == ("stream" if C == 1 else "wgmma")
    before = dict(tgmm.LAUNCHES)
    _check_moe_gmm(cuda, (E, C, D), (E, D, F), "bfloat16", w_scale=D ** -0.5)
    assert tgmm.LAUNCHES == {**before, route: before[route] + 1}


@pytest.mark.parametrize("E,C,D,F", PHI35_GMM)
def test_moe_gmm_bwd_at_phi35s_shapes(cuda, E, C, D, F):
    """The backward at phi3.5-moe's expert widths in bf16, dx and dw on
    the routes of ``bwd_route`` (at C 640, five 128-row tiles that do not
    pair: dx on ``wgmma_nt_fwd``; dw on ``wgmma_tn``), at the bf16 limit."""
    x = _randn(cuda, (E, C, D), torch.bfloat16)
    w = (_randn(cuda, (E, D, F), torch.float32) * D ** -0.5).to(torch.bfloat16)
    dy = _randn(cuda, (E, C, F), torch.bfloat16)
    r_dx, r_dw = tgmm.bwd_route(torch.bfloat16, C, D, F)
    assert r_dw == "wgmma_tn" and (C == 1 or r_dx == "wgmma_nt_fwd")
    before = dict(tgmm.BWD_LAUNCHES)
    dx, dw = tgmm.moe_gmm_bwd(x, w, dy)
    torch.cuda.synchronize()
    assert tgmm.BWD_LAUNCHES == {k: n + (k in (f"dx_{r_dx}", f"dw_{r_dw}"))
                                 for k, n in before.items()}
    ex, ew = ref.moe_gmm_bwd_ref(x, w, dy)
    _assert_close(dx, ex, "bfloat16")
    _assert_close(dw, ew, "bfloat16")


# ---------------------------------------------------------------------------
# The two scans: fp32 at 2e-4, the limit of tests/test_kernels.py; bf16 at
# one ulp of the output, as above


SCAN_TOL = {"float32": (2e-4, 2e-4), "bfloat16": TOL["bfloat16"]}
MAMBA_CASES = [   # B, S, di, ds, with a state
    (2, 128, 64, 16, False), (1, 256, 128, 8, False), (2, 64, 32, 4, False),  # test_kernels
    (2, 150, 64, 16, True),                 # S not a multiple of the kernel's 32-step chunk
    (3, 77, 333, 16, True),                 # odd di: a ragged block of channels
    (4, 1, 256, 16, True),                  # one step from a state, as at decode
]
RWKV_CASES = [    # B, T, H, hd, with a state
    (2, 128, 2, 64, False), (1, 64, 4, 32, False), (2, 96, 1, 16, False),     # test_kernels
    (2, 150, 2, 64, True),                  # T not a multiple of the 32-step chunk
    (3, 1, 4, 64, True),                    # one step from a state, as at decode
    (1, 70, 3, 32, True),
]


def _mamba_inputs(gen, B, S, di, ds, dtype, with_state=True):
    """Scan terms at the scales of tests/test_kernels.py, and an fp32 state."""
    dt = (torch.nn.functional.softplus(_randn(gen, (B, S, di), torch.float32)) * 0.1).to(dtype)
    dtx = (_randn(gen, (B, S, di), torch.float32) * 0.1).to(dtype)
    Bm, Cm = _randn(gen, (B, S, ds), dtype), _randn(gen, (B, S, ds), dtype)
    A = (-torch.exp(_randn(gen, (di, ds), torch.float32))).to(dtype)
    h0 = _randn(gen, (B, di, ds), torch.float32) if with_state else None
    return dt, dtx, Bm, Cm, A, h0


def _rwkv_inputs(gen, B, T, H, hd, dtype, with_state=True):
    r = _randn(gen, (B, T, H, hd), dtype)
    k = (_randn(gen, (B, T, H, hd), torch.float32) * 0.3).to(dtype)
    v = (_randn(gen, (B, T, H, hd), torch.float32) * 0.3).to(dtype)
    w = torch.sigmoid(_randn(gen, (B, T, H, hd), torch.float32) * 0.5 + 2).to(dtype)
    u = (_randn(gen, (H, hd), torch.float32) * 0.1).to(dtype)
    S0 = _randn(gen, (B, H, hd, hd), torch.float32) * 0.3 if with_state else None
    return r, k, v, w, u, S0


def _check_scan(name, op, plain, args, dtype, design=None):
    """``op`` against ``plain``; ``design``, where given, is the route whose
    count the launch must raise by one."""
    counts = ops.ROUTE_LAUNCHES[name] if design else ops.LAUNCHES
    before = counts[design or name]
    out, state = op(*args)
    torch.cuda.synchronize()
    assert counts[design or name] == before + 1
    expect, expect_state = plain(*args)
    assert out.dtype == args[0].dtype and state.dtype == torch.float32
    atol, rtol = SCAN_TOL[dtype]
    torch.testing.assert_close(out.float(), expect.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(state, expect_state, atol=2e-4, rtol=2e-4)


MAMBA_SERVING = [(8, 512, 8192, 16, True),   # jamba-v0.1-52b prefill of 8 x 512 tokens
                 (8, 1, 8192, 16, True)]     # jamba decode step
RWKV_SERVING = [(8, 512, 32, 64, True),      # rwkv6-1.6b prefill of 8 x 512 tokens
                (8, 1, 32, 64, True)]        # rwkv6 decode step


@pytest.mark.parametrize("design", ["lanes", "simt"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,di,ds,with_state", MAMBA_CASES + MAMBA_SERVING + [
    (2, 40, 70, 12, True),                  # ds 12: lanes leaves a lane of each group empty
])
def test_mamba_scan_kernel(cuda, B, S, di, ds, with_state, dtype, design):
    """Both designs: lanes through ops (every case has ds a multiple of 4),
    simt through its own entry point; the ragged (3, 77, 333, 16) tail too."""
    args = _mamba_inputs(cuda, B, S, di, ds, getattr(torch, dtype), with_state)
    assert tmamba.route(getattr(torch, dtype), ds) == "lanes"
    op = ops.mamba_scan if design == "lanes" else tmamba.mamba_scan_simt
    _check_scan("mamba_scan", op, ref.mamba_scan_ref, args, dtype, design)


@pytest.mark.parametrize("design", ["cols", "simt"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,hd,with_state", RWKV_CASES + RWKV_SERVING)
def test_rwkv6_scan_kernel(cuda, B, T, H, hd, with_state, dtype, design):
    """Both designs: cols through ops, simt through its own entry point;
    the ragged (1, 70, 3, 32) tail too."""
    args = _rwkv_inputs(cuda, B, T, H, hd, getattr(torch, dtype), with_state)
    assert trwkv.route(getattr(torch, dtype), hd) == "cols"
    op = ops.rwkv6_scan if design == "cols" else trwkv.rwkv6_scan_simt
    _check_scan("rwkv6_scan", op, ref.rwkv6_scan_ref, args, dtype, design)


@pytest.mark.parametrize("case", MAMBA_SERVING)
def test_mamba_scan_routes_agree_at_the_serving_shape(cuda, case):
    args = _mamba_inputs(cuda, *case[:4], torch.float32, case[4])
    y, h = ops.mamba_scan(*args)
    y_prev, h_prev = tmamba.mamba_scan_simt(*args)
    torch.testing.assert_close(y, y_prev, **dict(zip(("atol", "rtol"), SCAN_TOL["float32"])))
    torch.testing.assert_close(h, h_prev, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("case", RWKV_SERVING)
def test_rwkv6_scan_routes_agree_at_the_serving_shape(cuda, case):
    args = _rwkv_inputs(cuda, *case[:4], torch.float32, case[4])
    o, S = ops.rwkv6_scan(*args)
    o_prev, S_prev = trwkv.rwkv6_scan_simt(*args)
    torch.testing.assert_close(o, o_prev, **dict(zip(("atol", "rtol"), SCAN_TOL["float32"])))
    torch.testing.assert_close(S, S_prev, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_designs_shared_memory_matches_the_geometry(cuda, dtype):
    """The wrappers' launch geometry counts the shared memory that the
    compiled sources declare."""
    assert tmamba.lanes_smem_bytes(dtype) == \
        tmamba.lanes_geometry(1, 1, 64, 16, dtype.itemsize).smem
    for hd in trwkv.HEAD_SIZES:
        assert trwkv.cols_smem_bytes(hd, dtype) == \
            trwkv.cols_geometry(1, 1, 1, hd, dtype.itemsize).smem


def test_scan_kernels_on_an_empty_input(cuda):
    before = dict(ops.LAUNCHES)
    dt, dtx, Bm, Cm, A, h0 = _mamba_inputs(cuda, 2, 0, 64, 16, torch.float32)
    y, h = ops.mamba_scan(dt, dtx, Bm, Cm, A, h0)
    assert y.shape == (2, 0, 64) and torch.equal(h, h0)
    r, k, v, w, u, S0 = _rwkv_inputs(cuda, 2, 0, 2, 64, torch.float32)
    o, S = ops.rwkv6_scan(r, k, v, w, u, S0)
    assert o.shape == (2, 0, 2, 64) and torch.equal(S, S0)
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("case", ["dtype", "mixed", "strided", "shape", "ds", "state_dtype",
                                  "state_shape"])
def test_mamba_scan_kernel_refuses_bad_operands(cuda, case):
    from repro_torch.kernels.mamba_scan import mamba_scan
    dt, dtx, Bm, Cm, A, h0 = _mamba_inputs(cuda, 2, 8, 64, 16, torch.float32)
    if case == "dtype":
        dt, dtx, Bm, Cm, A = (t.half() for t in (dt, dtx, Bm, Cm, A))
    elif case == "mixed":
        A = A.bfloat16()
    elif case == "strided":
        Bm = _randn(cuda, (2, 8, 32), torch.float32)[..., ::2]
    elif case == "shape":
        dtx = dtx[:, :7].contiguous()
    elif case == "ds":
        Bm, Cm, A = (_randn(cuda, s, torch.float32) for s in ((2, 8, 17), (2, 8, 17), (64, 17)))
    elif case == "state_dtype":
        h0 = h0.bfloat16()
    else:
        h0 = h0[:, :32].contiguous()
    with pytest.raises(ValueError, match="mamba_scan"):
        mamba_scan(dt, dtx, Bm, Cm, A, h0)


@pytest.mark.parametrize("case", ["dtype", "mixed", "strided", "shape", "head_size",
                                  "state_dtype", "state_shape"])
def test_rwkv6_scan_kernel_refuses_bad_operands(cuda, case):
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    r, k, v, w, u, S0 = _rwkv_inputs(cuda, 2, 8, 2, 64, torch.float32)
    if case == "dtype":
        r, k, v, w, u = (t.half() for t in (r, k, v, w, u))
    elif case == "mixed":
        u = u.bfloat16()
    elif case == "strided":
        r = _randn(cuda, (2, 8, 2, 128), torch.float32)[..., ::2]
    elif case == "shape":
        v = v[:, :7].contiguous()
    elif case == "head_size":
        r, k, v, w, u, S0 = _rwkv_inputs(cuda, 2, 8, 2, 48, torch.float32)
    elif case == "state_dtype":
        S0 = S0.double()
    else:
        S0 = S0[:1].contiguous()
    with pytest.raises(ValueError, match="rwkv6_scan"):
        rwkv6_scan(r, k, v, w, u, S0)


# ---------------------------------------------------------------------------
# AES-128-CTR

FIPS_KEY = list(range(16))
FIPS_PT = bytes.fromhex("00112233445566778899aabbccddeeff")
FIPS_CT = "69c4e0d86a7b0430d8cdb78070b4c55a"


def _aes_key(cuda, which):
    if which == "fips":
        return torch.tensor(FIPS_KEY, dtype=torch.int32, device="cuda")
    return torch.randint(0, 256, (16,), generator=cuda, device="cuda", dtype=torch.int32)


def _int32_blocks(cuda, n):
    return torch.randint(-2**31, 2**31, (n, 16), generator=cuda, device="cuda",
                         dtype=torch.int64).to(torch.int32)


@pytest.mark.parametrize("which", ["fips", "random"])
@pytest.mark.parametrize("nonce", [0, 7, 2**31 - 20])
@pytest.mark.parametrize("n", [1, 38, 40, 4096, 2**20])
def test_aes_ctr_kernel(cuda, n, nonce, which):
    key, pt = _aes_key(cuda, which), _int32_blocks(cuda, n)
    before = ops.LAUNCHES["aes_ctr"]
    out = ops.aes_ctr(pt, key, nonce=nonce)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["aes_ctr"] == before + 1
    assert torch.equal(out, ref.aes_ctr_ref(pt, key, nonce))
    assert torch.equal(ops.aes_ctr(out, key, nonce=nonce), pt)


def test_aes_fips197_vector(cuda):
    key = _aes_key(cuda, "fips")
    block = torch.tensor(list(FIPS_PT), dtype=torch.int32, device="cuda")
    assert bytes(ref.aes_encrypt_block_ref(block, ref.aes_key_expand(key)).tolist()).hex() \
        == FIPS_CT
    pt = block.repeat(38, 1)
    ct = ops.aes_ctr(pt, key)
    assert torch.equal(ct ^ pt, ref.aes_ctr_keystream(38, ref.aes_key_expand(key)))


def test_aes_ctr_kernel_on_an_empty_plaintext(cuda):
    before = ops.LAUNCHES["aes_ctr"]
    out = ops.aes_ctr(_int32_blocks(cuda, 0), _aes_key(cuda, "fips"))
    assert out.shape == (0, 16) and ops.LAUNCHES["aes_ctr"] == before


@pytest.mark.parametrize("case", ["dtype", "shape", "strided", "keys_shape"])
def test_aes_ctr_kernel_refuses_bad_operands(cuda, case):
    from repro_torch.kernels.aes_ctr import aes_ctr
    pt = _int32_blocks(cuda, 64)
    rk = ref.aes_key_expand(_aes_key(cuda, "fips"))
    if case == "dtype":
        pt = pt.long()
    elif case == "shape":
        pt = pt.reshape(128, 8)
    elif case == "strided":
        pt = _int32_blocks(cuda, 128)[::2]
    else:
        rk = rk.reshape(16, 11)
    with pytest.raises(ValueError, match="aes_ctr"):
        aes_ctr(pt, rk)


AES_ROUTE_N = [1, 38, 40, 4096, 2**20,
               513,                  # not a multiple of blocks-a-thread x threads
               135169]               # past the persistent grid's first pass, ragged


@pytest.mark.parametrize("design", ["ttable", "simt"])
@pytest.mark.parametrize("nonce", [0, 7, 2**31 - 20, 2**32 - 20])   # the last wraps past 2**32
@pytest.mark.parametrize("n", AES_ROUTE_N)
def test_aes_ctr_each_design(cuda, n, nonce, design):
    from repro_torch.kernels import aes_ctr as taes
    key, pt = _aes_key(cuda, "random"), _int32_blocks(cuda, n)
    assert taes.route(n) == "ttable"
    fn = {"ttable": taes.aes_ctr, "simt": taes.aes_ctr_simt}[design]
    before = taes.LAUNCHES[design]
    out = fn(pt, ref.aes_key_expand(key), nonce=nonce)
    torch.cuda.synchronize()
    assert taes.LAUNCHES[design] == before + 1
    assert torch.equal(out, ref.aes_ctr_ref(pt, key, nonce))


def test_aes_ctr_route_counts_add_up(cuda):
    from repro_torch.kernels import aes_ctr as taes
    ops.reset_launches()
    key = _aes_key(cuda, "fips")
    rk = ref.aes_key_expand(key)
    sizes = (1, 38, 4096, 0)
    for n in sizes:
        ops.aes_ctr(_int32_blocks(cuda, n), key)
        ops.aes_ctr_expanded(_int32_blocks(cuda, n), rk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["aes_ctr"] == 6
    assert sum(ops.ROUTE_LAUNCHES["aes_ctr"].values()) == 6
    expect = {"ttable": 0, "simt": 0}
    for n in sizes[:-1]:
        expect[taes.route(n)] += 2
    assert ops.ROUTE_LAUNCHES["aes_ctr"] == expect


@pytest.mark.parametrize("nonce", [0, 2**31 - 20])
@pytest.mark.parametrize("n", [38, 2**20])
def test_aes_ctr_expanded_kernel(cuda, n, nonce):
    key, pt = _aes_key(cuda, "random"), _int32_blocks(cuda, n)
    before = ops.LAUNCHES["aes_ctr"]
    out = ops.aes_ctr_expanded(pt, ref.aes_key_expand(key), nonce=nonce)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["aes_ctr"] == before + 1
    assert torch.equal(out, ref.aes_ctr_ref(pt, key, nonce))


@pytest.mark.parametrize("case", ["dtype", "shape", "strided", "keys_shape", "keys_dtype",
                                  "keys_on_cpu"])
def test_aes_ctr_expanded_refuses_bad_operands(cuda, case):
    pt = _int32_blocks(cuda, 64)
    rk = ref.aes_key_expand(_aes_key(cuda, "fips"))
    if case == "dtype":
        pt = pt.long()
    elif case == "shape":
        pt = pt.reshape(128, 8)
    elif case == "strided":
        pt = _int32_blocks(cuda, 128)[::2]
    elif case == "keys_shape":
        rk = rk.reshape(16, 11)
    elif case == "keys_dtype":
        rk = rk.long()
    else:
        rk = rk.cpu()
    before = ops.LAUNCHES["aes_ctr"]
    with pytest.raises(ValueError, match="aes_ctr"):
        ops.aes_ctr_expanded(pt, rk)
    assert ops.LAUNCHES["aes_ctr"] == before


def test_aes_function_deployed_on_the_card(cuda):
    from repro_torch.serving import AesFunction
    key = _aes_key(cuda, "random").cpu()
    fn = AesFunction(key, nonce=0)
    assert fn.round_keys.is_cuda
    payload = torch.randint(0, 256, (38, 16), dtype=torch.int32)
    before = ops.LAUNCHES["aes_ctr"]
    for _ in range(3):
        reply = fn(payload)
        assert reply.device.type == "cpu"
        assert torch.equal(reply, ref.aes_ctr_ref(payload, key, 0))
    assert ops.LAUNCHES["aes_ctr"] == before + 3


@pytest.mark.parametrize("dtype,F", [("float32", 64), ("bfloat16", 130)])
def test_moe_gmm_wgmma_entry_refuses_what_it_cannot_take(cuda, dtype, F):
    dt = getattr(torch, dtype)
    x, w = _randn(cuda, (2, 64, 32), dt), _randn(cuda, (2, 32, F), dt)
    with pytest.raises(ValueError, match="wgmma route"):
        tgmm.moe_gmm_wgmma(x, w)


# ---------------------------------------------------------------------------
# decode attention: both designs, and the cases that stress the split one


def _decode_valid(cuda, B, T, mask):
    j = torch.arange(T, device="cuda")
    if mask == "prefix":        # a 512-token prompt and one new token
        v = j <= min(512, T - 1)
    elif mask == "wrap":        # a ring that wraps: slots 700 .. T-1 and 0 .. 188
        v = (j >= min(700, T - 1)) | (j < 189)
    elif mask == "few":         # 3 valid slots in the first tile: the other splits get none
        v = (j == 1) | (j == 5) | (j == 63)
    else:                       # random, and the last row with no valid slot
        r = torch.rand((B, T), generator=cuda, device="cuda") < 0.5
        r[-1] = False
        return r
    return v[None].expand(B, T).contiguous()


DECODE_CASES = [   # B, Hq, Hkv, T, d, mask
    (2, 8, 2, 300, 64, "random"), (1, 4, 4, 512, 128, "random"), (3, 16, 8, 257, 64, "random"),
    (8, 16, 8, 1024, 128, "prefix"),        # the serving shape, 513 valid slots
    (8, 16, 8, 1024, 128, "wrap"),
    (8, 16, 8, 1024, 128, "random"),        # a row with no valid slot
    (8, 16, 8, 1024, 128, "few"),           # splits whose tiles are all invalid
    (8, 32, 8, 1024, 128, "prefix"),        # mixtral-8x7b's G = 4
    (3, 16, 8, 257, 128, "prefix"),         # one slot in the last tile
    (2, 16, 8, 1500, 128, "wrap"),
    (8, 32, 8, 1024, 120, "prefix"),        # h2o-danube-3-4b: head_dim 120
    (2, 32, 8, 300, 120, "random"),
    (2, 16, 2, 300, 32, "random"),          # G = 8
    (1, 2, 1, 9, 32, "random"),             # T shorter than a tile
    (8, 24, 8, 1024, 128, "prefix"),        # phi4-mini-3.8b's G = 3 at the serving cache
    (8, 24, 8, 1024, 128, "wrap"),
    (8, 24, 8, 1024, 128, "few"),
    (2, 24, 8, 300, 64, "random"),          # G = 3 at d 64, a row with no valid slot
    (8, 64, 8, 1024, 128, "prefix"),        # deepseek-67b: G = 8 at d 128
]


@pytest.mark.parametrize("B,Hq,Hkv,T,d,mask", DECODE_CASES)
@pytest.mark.parametrize("which", ["split", "simt"])
def test_decode_attention_routes_in_bf16(cuda, B, Hq, Hkv, T, d, mask, which):
    """Each design in bf16 against the plain version: the split one through
    the routed entry point, the simt one through its own."""
    q = _randn(cuda, (B, Hq, d), torch.bfloat16)
    k, v = (_randn(cuda, (B, T, Hkv, d), torch.bfloat16) for _ in range(2))
    valid = _decode_valid(cuda, B, T, mask)
    fn = tdecode.decode_attention if which == "split" else tdecode.decode_attention_simt
    assert tdecode.route(torch.bfloat16, Hq // Hkv, T) == "split"
    before = dict(tdecode.LAUNCHES)
    out = fn(q, k, v, valid)
    torch.cuda.synchronize()
    assert tdecode.LAUNCHES == {**before, which: before[which] + 1}
    _assert_close(out, ref.decode_attention_ref(q, k, v, valid), "bfloat16")


@pytest.mark.parametrize("B,Hq,Hkv,T,d,mask", [c for c in DECODE_CASES if c[4] == 120])
def test_decode_attention_head_dim_120_in_fp32(cuda, B, Hq, Hkv, T, d, mask):
    q = _randn(cuda, (B, Hq, d), torch.float32)
    k, v = (_randn(cuda, (B, T, Hkv, d), torch.float32) for _ in range(2))
    valid = _decode_valid(cuda, B, T, mask)
    out = ops.decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    _assert_close(out, ref.decode_attention_ref(q, k, v, valid), "float32")


@pytest.mark.parametrize("B,Hq,Hkv,T,d,mask", [
    (8, 8, 8, 2 ** 19, 32, "wrap"),      # 2 splits of 4096 tiles
    (17, 8, 8, 131136, 32, "random"),    # B x Hkv past the SMs: one split of 2049 tiles
])
def test_decode_split_at_long_rows(cuda, B, Hq, Hkv, T, d, mask):
    """Rows longer than 2048 tiles per split still take and pass the split
    design, at any batch."""
    q = _randn(cuda, (B, Hq, d), torch.bfloat16)
    k, v = (_randn(cuda, (B, T, Hkv, d), torch.bfloat16) for _ in range(2))
    valid = _decode_valid(cuda, B, T, mask)
    assert tdecode.route(torch.bfloat16, Hq // Hkv, T) == "split"
    before = dict(tdecode.LAUNCHES)
    out = tdecode.decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert tdecode.LAUNCHES == {**before, "split": before["split"] + 1}
    _assert_close(out, ref.decode_attention_ref(q, k, v, valid), "bfloat16")


def test_decode_split_is_deterministic_and_agrees_with_simt(cuda):
    B, Hq, Hkv, T, d = 8, 16, 8, 1024, 128
    q = _randn(cuda, (B, Hq, d), torch.bfloat16)
    k, v = (_randn(cuda, (B, T, Hkv, d), torch.bfloat16) for _ in range(2))
    valid = _decode_valid(cuda, B, T, "prefix")
    first = tdecode.decode_attention(q, k, v, valid)
    assert all(torch.equal(first, tdecode.decode_attention(q, k, v, valid.int()))
               for _ in range(3))
    _assert_close(first, tdecode.decode_attention_simt(q, k, v, valid), "bfloat16")


# ---------------------------------------------------------------------------
# flash attention at head_dim 120, both designs


@pytest.mark.parametrize("B,Hq,Hkv,S,T,d,causal,win", [
    (2, 32, 8, 200, 200, 120, True, None),
    (1, 4, 2, 70, 40, 120, True, None),     # S > T: rows with no allowed key
    (1, 8, 2, 300, 300, 120, True, 64),     # a window
    (1, 4, 4, 128, 128, 120, False, None),
    (8, 32, 8, 512, 512, 120, True, 4096),  # h2o-danube-3-4b's prefill at the serving traffic
])
@pytest.mark.parametrize("which", ["wgmma", "simt", "simt_fp32"])
def test_flash_attention_head_dim_120(cuda, B, Hq, Hkv, S, T, d, causal, win, which):
    dtype = "float32" if which == "simt_fp32" else "bfloat16"
    dt = getattr(torch, dtype)
    q = _randn(cuda, (B, Hq, S, d), dt)
    k, v = (_randn(cuda, (B, Hkv, T, d), dt) for _ in range(2))
    fn = tflash.flash_attention_simt if which == "simt" else tflash.flash_attention
    before = dict(tflash.LAUNCHES)
    out = fn(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    route = "wgmma" if which == "wgmma" else "simt"
    assert tflash.LAUNCHES == {**before, route: before[route] + 1}
    _assert_close(out, ref.flash_attention_ref(q, k, v, causal=causal, window=win), dtype)


# ---------------------------------------------------------------------------
# the stream design of moe_gmm (bf16, C <= 8)


@pytest.mark.parametrize("E,C,D,F", [
    (8, 2, 4096, 14336), (8, 2, 14336, 4096),     # mixtral-8x7b decode: gate/up, down
    (16, 1, 4096, 14336), (16, 1, 14336, 4096),   # jamba-v0.1-52b decode
    (3, 5, 96, 72),                               # ragged C, E; D and F below a tile
    (5, 6, 4096, 200),                            # C at the threshold, an F tail
    (1, 3, 8, 8),
    (2, 4, 1000, 1032),                           # D and F tails
])
def test_moe_gmm_stream_route(cuda, E, C, D, F):
    assert tgmm.route(torch.bfloat16, C, D, F) == "stream"
    before = dict(tgmm.LAUNCHES)
    _check_moe_gmm(cuda, (E, C, D), (E, D, F), "bfloat16", w_scale=D ** -0.5)
    assert tgmm.LAUNCHES == {**before, "stream": before["stream"] + 1}


@pytest.mark.parametrize("C", [7, 8])
def test_moe_gmm_stream_past_the_threshold(cuda, C):
    """The kernel takes C up to 8, past the route's threshold, so that the
    three designs can be timed across it."""
    x = _randn(cuda, (4, C, 512), torch.bfloat16)
    w = (_randn(cuda, (4, 512, 264), torch.float32) * 512 ** -0.5).bfloat16()
    out = tgmm.moe_gmm_stream(x, w)
    torch.cuda.synchronize()
    _assert_close(out, ref.moe_gmm_ref(x, w), "bfloat16")


@pytest.mark.parametrize("case", ["fp32", "ragged_f", "ragged_d", "too_many_rows"])
def test_moe_gmm_stream_entry_refuses_what_it_cannot_take(cuda, case):
    E, C, D, F, dt = 2, 2, 64, 64, torch.bfloat16
    if case == "fp32":
        dt = torch.float32
    elif case == "ragged_f":
        F = 130
    elif case == "ragged_d":
        D = 100
    else:
        C = tgmm.STREAM_KERNEL_MAX_C + 1
    x, w = _randn(cuda, (E, C, D), dt), _randn(cuda, (E, D, F), dt)
    with pytest.raises(ValueError, match="stream route"):
        tgmm.moe_gmm_stream(x, w)


@pytest.mark.parametrize("E,C,D,F", [
    (8, 2, 4096, 14336), (8, 2, 14336, 4096), (16, 1, 4096, 14336), (16, 1, 14336, 4096)])
def test_moe_gmm_decode_designs_agree(cuda, E, C, D, F):
    """The stream design and the previous one (mma_sync) on the same bf16
    operands at the decode shapes."""
    x = _randn(cuda, (E, C, D), torch.bfloat16)
    w = (_randn(cuda, (E, D, F), torch.float32) * D ** -0.5).bfloat16()
    _assert_close(tgmm.moe_gmm(x, w), tgmm.moe_gmm_mma_sync(x, w), "bfloat16")


# ---------------------------------------------------------------------------
# the encoder-decoder and frontend models: flash without the causal bound at
# seamless-m4t's shapes (a ragged T of 1500 = 11 x 128 + 92, S != T, d 64 at
# G = 1) and at pixtral-12b's prefill; decode against cross-attention K/V


ENCDEC_FLASH = [   # B, Hq, Hkv, S, T, d, causal
    (8, 16, 16, 1500, 1500, 64, False),     # seamless-m4t's encoder
    (8, 16, 16, 512, 1500, 64, False),      # its cross-attention at the prefill
    (2, 4, 4, 37, 1500, 64, False),         # S < T: no prefix offset without the causal bound
    (1, 4, 4, 1500, 37, 64, False),         # S > T
    (8, 32, 8, 1024, 1024, 128, True),      # pixtral-12b's prefill
]


@pytest.mark.parametrize("B,Hq,Hkv,S,T,d,causal", ENCDEC_FLASH)
@pytest.mark.parametrize("which", ["wgmma", "simt"])
def test_flash_attention_at_the_encdec_shapes(cuda, B, Hq, Hkv, S, T, d, causal, which):
    q = _randn(cuda, (B, Hq, S, d), torch.bfloat16)
    k, v = (_randn(cuda, (B, Hkv, T, d), torch.bfloat16) for _ in range(2))
    fn = tflash.flash_attention if which == "wgmma" else tflash.flash_attention_simt
    before = dict(tflash.LAUNCHES)
    out = fn(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tflash.LAUNCHES == {**before, which: before[which] + 1}
    _assert_close(out, ref.flash_attention_ref(q, k, v, causal=causal), "bfloat16")


def _key_valid(B, T, lengths):
    return torch.arange(T, device="cuda")[None] < torch.tensor(lengths, device="cuda")[:, None]


def _masked_designs(dtype):
    """The masked designs a dtype runs, by route: the wrapper's, and for
    bf16 the simt one on its own entry point."""
    dt = getattr(torch, dtype)
    designs = {tflash.route(dt, True): tflash.flash_attention}
    if dt == torch.bfloat16:
        assert set(designs) == {"wgmma_masked"}
        designs["masked"] = tflash.flash_attention_masked_simt
    return designs


def _check_masked(q, k, v, valid, dtype, causal=False, win=None):
    """Each masked design of ``dtype`` against the plain version, one launch
    each on its own route; returns the plain output."""
    plain = ref.flash_attention_ref(q, k, v, causal=causal, window=win, key_valid=valid)
    for which, fn in _masked_designs(dtype).items():
        before = dict(tflash.LAUNCHES)
        out = fn(q, k, v, causal=causal, window=win, key_valid=valid)
        torch.cuda.synchronize()
        assert tflash.LAUNCHES == {**before, which: before[which] + 1}
        _assert_close(out, plain, dtype)
    return plain


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_masked_at_the_cross_prefill_shape(cuda, dtype):
    """seamless-m4t's cross prefill (B8 H16/16, S 512, T 1500, d 64) under a
    ragged encoder mask with one fully masked row, which averages v over
    all of T as the plain version does; bf16 on both designs."""
    B, Hq, Hkv, S, T, d = 8, 16, 16, 512, 1500, 64
    dt = getattr(torch, dtype)
    q = _randn(cuda, (B, Hq, S, d), dt)
    k, v = (_randn(cuda, (B, Hkv, T, d), dt) for _ in range(2))
    lengths = [T - 97 * b for b in range(B)]
    lengths[1] = 0
    valid = _key_valid(B, T, lengths)
    assert tflash.route(dt, True) == ("wgmma_masked" if dtype == "bfloat16" else "masked")
    before = dict(tflash.LAUNCHES)
    out = ops.flash_attention(q, k, v, causal=False, key_valid=valid)
    torch.cuda.synchronize()
    route = tflash.route(dt, True)
    assert tflash.LAUNCHES == {**before, route: before[route] + 1}
    plain = _check_masked(q, k, v, valid, dtype)
    _assert_close(out, plain, dtype)
    _assert_close(out[1], v[1].float().mean(1, keepdim=True).expand(Hkv, S, d), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,S,T,d,causal,win,lengths", [
    (2, 4, 2, 37, 150, 32, False, None, (150, 1)),        # G 2, a row with one key
    (3, 4, 4, 70, 129, 120, False, None, (0, 64, 65)),    # head_dim 120, tile edges
    (2, 8, 2, 96, 200, 128, False, None, (200, 0)),
    (2, 4, 2, 128, 128, 64, True, None, (128, 40)),       # causal under the mask
    (1, 8, 2, 96, 96, 64, True, 32, (50,)),               # and a window
])
def test_flash_attention_masked_kernel(cuda, B, Hq, Hkv, S, T, d, causal, win, lengths, dtype):
    dt = getattr(torch, dtype)
    q = _randn(cuda, (B, Hq, S, d), dt)
    k, v = (_randn(cuda, (B, Hkv, T, d), dt) for _ in range(2))
    _check_masked(q, k, v, _key_valid(B, T, lengths), dtype, causal, win)


def _holed_valid(B, T, pattern, gen):
    """Masks that the live-tile walk treats apart, a row each."""
    t = torch.arange(T, device="cuda")
    rows = []
    for b in range(B):
        if pattern == "holes":          # dead tiles mid-row; keys only in the last tile
            row = ((t < 128) | (t >= 320)) & ~((t >= 640) & (t < 832)) if b % 2 == 0 else \
                t >= (T - 1) // 64 * 64 + 3
            row &= torch.rand(T, generator=gen, device="cuda") < (0.6 if b % 4 == 0 else 1.0)
        else:   # "future": keys past the early queries, or only before the late windows
            row = t >= 40 + 30 * b if b % 2 == 0 else t < 20 + 30 * b
        rows.append(row)
    return torch.stack(rows)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pattern,B,Hq,Hkv,S,T,d,causal,win", [
    ("holes", 4, 4, 2, 300, 1000, 64, False, None),    # dead tiles mid-row, ragged T
    ("holes", 2, 2, 1, 130, 700, 128, False, 200),    # and under a window
    ("future", 3, 4, 2, 200, 200, 64, True, None),    # causal: early rows see no valid key
    ("future", 2, 4, 4, 160, 300, 120, True, 96),     # causal with a window, S < T
])
def test_flash_attention_masked_skips_dead_tiles_and_walks_empty_rows(
        cuda, pattern, B, Hq, Hkv, S, T, d, causal, win, dtype):
    """The live-tile walk: whole dead tiles in the middle of a row, a row
    whose only valid keys sit in its last partial tile, and rows whose valid
    keys all lie in their causal future or before their window (their
    block walks every tile, and such a row averages v over T)."""
    dt = getattr(torch, dtype)
    q = _randn(cuda, (B, Hq, S, d), dt)
    k, v = (_randn(cuda, (B, Hkv, T, d), dt) for _ in range(2))
    _check_masked(q, k, v, _holed_valid(B, T, pattern, cuda), dtype, causal, win)


def test_flash_attention_masked_refuses_a_bad_mask(cuda):
    q = _randn(cuda, (2, 4, 9, 32), torch.float32)
    k = _randn(cuda, (2, 2, 9, 32), torch.float32)
    for bad in (torch.ones((2, 8), dtype=torch.bool, device="cuda"),
                torch.ones((2, 9), dtype=torch.int32, device="cuda"),
                torch.ones((2, 9), dtype=torch.bool)):
        with pytest.raises(ValueError, match="key_valid"):
            tflash.flash_attention(q, k, k, key_valid=bad)


def _cross_valid(B, T, mask):
    """All 1500 encoder frames valid, or a ragged prefix of each row."""
    if mask == "all":
        return torch.ones((B, T), dtype=torch.bool, device="cuda")
    lengths = torch.tensor([T - 97 * b for b in range(B)], device="cuda")
    return torch.arange(T, device="cuda")[None] < lengths[:, None]


@pytest.mark.parametrize("mask", ["all", "prefix"])
@pytest.mark.parametrize("which", ["split", "simt"])
def test_decode_attention_at_the_cross_shape(cuda, mask, which):
    """One decoder token against seamless-m4t's 1500 encoder frames (G = 1,
    d 64), not a ring: every tile live under the all-valid mask."""
    B, Hq, Hkv, T, d = 8, 16, 16, 1500, 64
    q = _randn(cuda, (B, Hq, d), torch.bfloat16)
    k, v = (_randn(cuda, (B, T, Hkv, d), torch.bfloat16) for _ in range(2))
    valid = _cross_valid(B, T, mask)
    assert tdecode.route(torch.bfloat16, Hq // Hkv, T) == "split"
    fn = tdecode.decode_attention if which == "split" else tdecode.decode_attention_simt
    before = dict(tdecode.LAUNCHES)
    out = fn(q, k, v, valid)
    torch.cuda.synchronize()
    assert tdecode.LAUNCHES == {**before, which: before[which] + 1}
    _assert_close(out, ref.decode_attention_ref(q, k, v, valid), "bfloat16")


def test_reduced_seamless_in_bf16_on_the_card(cuda):
    """Reduced seamless-m4t in bf16 with the same weights on the card
    (kernels) and on the CPU (plain versions): prefill and 4 decode steps
    over 150 encoder frames.  Every matmul and norm rounds to bf16 on both
    sides, in other orders, so the logits are held at the bf16 limit of
    ``tests/test_kernels.py`` (atol = rtol = 5e-2), and the kernels'
    launches are counted."""
    from repro_torch.config import get_arch, reduced
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import tree_to

    cfg = reduced(get_arch("seamless-m4t-large-v2"))
    assert cfg.dtype == "bfloat16"
    p_cpu = T.init_params(cfg, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 40), generator=g)
    enc = torch.randn((4, 150, cfg.d_model), generator=g).bfloat16()
    logits = {}
    for where, p in (("cpu", p_cpu), ("cuda", tree_to(p_cpu, "cuda"))):
        ops.reset_launches()
        batch = {"tokens": toks.to(where), "enc_embeds": enc.to(where)}
        lg, c = T.prefill(p, cfg, batch, seq_len=48)
        steps = [lg.float().cpu()]
        for i in range(4):
            nxt = toks[:, i:i + 1].to(where)        # the same tokens on both sides
            lg, c = T.decode_step(p, cfg, nxt, 40 + i, c)
            steps.append(lg.float().cpu())
        logits[where] = steps
    L = cfg.n_layers
    assert ops.LAUNCHES["flash_attention"] == cfg.encdec.encoder_layers + 2 * L   # + self, cross
    assert ops.LAUNCHES["decode_attention"] == 2 * L * 4
    for got, expect in zip(logits["cuda"], logits["cpu"]):
        torch.testing.assert_close(got, expect, atol=5e-2, rtol=5e-2)


def test_reduced_seamless_under_an_enc_mask_on_the_card(cuda):
    """The same under a ragged ``enc_mask``: the cross prefill takes the
    flash kernel's ``wgmma_masked`` route, the decode steps the decode
    kernel's mask, and the logits hold at the bf16 limit against the plain
    versions."""
    from repro_torch.config import get_arch, reduced
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import tree_to

    cfg = reduced(get_arch("seamless-m4t-large-v2"))
    p_cpu = T.init_params(cfg, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (4, 40), generator=g)
    enc = torch.randn((4, 150, cfg.d_model), generator=g).bfloat16()
    mask = torch.arange(150)[None] < torch.tensor([150, 97, 31, 64])[:, None]
    logits = {}
    for where, p in (("cpu", p_cpu), ("cuda", tree_to(p_cpu, "cuda"))):
        ops.reset_launches()
        batch = {"tokens": toks.to(where), "enc_embeds": enc.to(where),
                 "enc_mask": mask.to(where)}
        lg, c = T.prefill(p, cfg, batch, seq_len=48)
        steps = [lg.float().cpu()]
        for i in range(4):
            lg, c = T.decode_step(p, cfg, toks[:, i:i + 1].to(where), 40 + i, c)
            steps.append(lg.float().cpu())
        logits[where] = steps
    L, E = cfg.n_layers, cfg.encdec.encoder_layers
    assert tflash.LAUNCHES == {"wgmma": E + L, "simt": 0, "masked": 0, "wgmma_masked": L}
    assert ops.LAUNCHES["decode_attention"] == 2 * L * 4
    for got, expect in zip(logits["cuda"], logits["cpu"]):
        torch.testing.assert_close(got, expect, atol=5e-2, rtol=5e-2)


# ---------------------------------------------------------------------------
# The flash backward: both kernels of each design against the plain version,
# at the limits of the forward (all compute in fp32 and round once); the
# op's gradient on the card; every other op refuses one; a reduced train
# step, card against CPU

BWD_PAIRS = {"simt": ("bwd_dq", "bwd_dkv"), "wgmma": ("bwd_dq_wgmma", "bwd_dkv_wgmma")}


@pytest.mark.parametrize("dtype,design", [("float32", "simt"), ("bfloat16", "wgmma"),
                                          ("bfloat16", "simt")])
@pytest.mark.parametrize("B,Hq,Hkv,S,T,d,causal,win", FLASH_SWEEP + [
    (1, 4, 2, 70, 40, 32, True, None),       # S > T: rows that see no key
    (2, 4, 2, 100, 300, 64, True, None),     # S < T: the causal offset
    (1, 8, 2, 300, 300, 120, True, 64),      # d 120 under a window
    (8, 16, 8, 512, 512, 128, True, None),   # qwen3-1.7b's training shape
    (2, 24, 8, 512, 512, 128, True, None),   # phi4-mini-3.8b's G = 3
    (1, 64, 8, 512, 512, 128, True, None),   # deepseek-67b's G = 8 at d 128
])
def test_flash_attention_bwd_kernels(cuda, B, Hq, Hkv, S, T, d, causal, win, dtype, design):
    dt = getattr(torch, dtype)
    q, dout = (_randn(cuda, (B, Hq, S, d), dt) for _ in range(2))
    k, v = (_randn(cuda, (B, Hkv, T, d), dt) for _ in range(2))
    o = ref.flash_attention_ref(q, k, v, causal=causal, window=win)
    fn = (tflash.flash_attention_bwd if tflash.bwd_route(dt) == design
          else tflash.flash_attention_bwd_simt)
    before = dict(tflash.BWD_LAUNCHES)
    got = fn(q, k, v, o, dout, causal=causal, window=win)
    torch.cuda.synchronize()
    assert tflash.BWD_LAUNCHES == {r: n + (r in BWD_PAIRS[design]) for r, n in before.items()}
    expect = ref.flash_attention_bwd_ref(q, k, v, o, dout, causal=causal, window=win)
    for g, e in zip(got, expect):
        assert g.dtype == dt and g.shape == e.shape
        _assert_close(g, e, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_on_the_card_has_a_grad_fn(cuda, dtype):
    """Under grad mode the op's output joins the graph, and its backward
    launches the two backward kernels and gives the plain version's
    gradients; under no_grad nothing changes."""
    dt = getattr(torch, dtype)
    q = _randn(cuda, (2, 4, 96, 64), dt).requires_grad_(True)
    k, v = (_randn(cuda, (2, 2, 96, 64), dt).requires_grad_(True) for _ in range(2))
    dout = _randn(cuda, (2, 4, 96, 64), dt)
    ops.reset_launches()
    out = ops.flash_attention(q, k, v, causal=True, window=32)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == ops.LAUNCHES["flash_attention_bwd"] == 1
    pair = BWD_PAIRS[tflash.bwd_route(dt)]
    assert ops.ROUTE_LAUNCHES["flash_attention_bwd"] == {
        r: int(r in pair) for r in tflash.BWD_LAUNCHES}
    expect = ref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), out.detach(),
                                         dout, causal=True, window=32)
    for g, e in zip(grads, expect):
        _assert_close(g, e, dtype)
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).grad_fn is None


def test_every_other_op_refuses_a_gradient_on_the_card(cuda):
    """No op returns an output cut off from the graph: without a backward
    kernel (decode attention and AES, which no training path reaches) it
    raises under grad mode, and runs under no_grad.  Flash under a key mask
    has its backward kernels
    (``test_flash_attention_under_a_key_mask_on_the_card_has_a_grad_fn``)."""
    g = lambda *s: _randn(cuda, s, torch.float32).requires_grad_(True)  # noqa: E731
    valid = torch.ones((2, 64), dtype=torch.bool, device="cuda")
    calls = {
        "decode_attention": lambda: ops.decode_attention(g(2, 4, 64), g(2, 64, 2, 64),
                                                         g(2, 64, 2, 64), valid),
    }
    for name, call in calls.items():
        with pytest.raises(NotImplementedError, match="no training path"):
            call()
        with torch.no_grad():
            call()
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# The backward of the key-masked routes: the masked pair of each design
# (bwd_route under a mask: bf16 -> wgmma_live, from the forward's lse; fp32
# -> masked; for bf16 also the simt masked pair and the previous wgmma
# masked pair, each on its own entry points) against the plain version, at
# the forward's limits; ragged masks with a fully masked row, dead tiles, rows whose valid
# keys lie in their causal future, G 1, 2 and 4, T 1500

MASKED_BWD_CASES = [   # B, Hq, Hkv, S, T, d, causal, win, mask
    (8, 16, 16, 512, 1500, 64, False, None, "phase3"),   # seamless's cross (11f's)
    (3, 4, 4, 70, 129, 120, False, None, "ragged"),      # G 1, d 120, tile edges
    (2, 8, 2, 96, 200, 128, False, None, "ragged"),      # G 4, d 128
    (3, 4, 2, 200, 200, 64, True, None, "future"),       # causal: early rows see no valid key
    (2, 4, 2, 160, 300, 120, True, 96, "future"),        # causal with a window, S < T
    (4, 4, 2, 300, 1000, 32, False, None, "holes"),      # dead tiles mid-row, G 2, d 32
    (2, 2, 1, 130, 700, 128, False, 200, "holes"),       # and under a window
    (2, 4, 2, 90, 60, 32, True, None, "ragged"),         # S > T: rows at negative positions
]


def _masked_bwd_valid(B, T, kind, gen):
    if kind == "phase3":        # 11f's ragged lengths with row 1 fully masked
        lengths = [T - 97 * b for b in range(B)]
        lengths[1] = 0
        return _key_valid(B, T, lengths)
    if kind == "ragged":
        return _key_valid(B, T, [(T, 0, 64, 65)[b % 4] for b in range(B)])
    return _holed_valid(B, T, kind, gen)


@pytest.mark.parametrize("dtype,design", [("float32", "masked"), ("bfloat16", "wgmma_live"),
                                          ("bfloat16", "wgmma_masked"), ("bfloat16", "masked")])
@pytest.mark.parametrize("B,Hq,Hkv,S,T,d,causal,win,kind", MASKED_BWD_CASES)
def test_flash_attention_masked_bwd_kernels(cuda, B, Hq, Hkv, S, T, d, causal, win, kind,
                                            dtype, design):
    dt = getattr(torch, dtype)
    q, dout = (_randn(cuda, (B, Hq, S, d), dt) for _ in range(2))
    k, v = (_randn(cuda, (B, Hkv, T, d), dt) for _ in range(2))
    valid = _masked_bwd_valid(B, T, kind, cuda)
    kw = dict(causal=causal, window=win, key_valid=valid)
    if design == "wgmma_live":   # the live pair takes the forward's lse
        o, lse = tflash.flash_attention(q, k, v, return_lse=True, **kw)
        kw_fn = dict(kw, lse=lse)
    else:
        o, kw_fn = ref.flash_attention_ref(q, k, v, **kw), kw
    fn = {"masked": tflash.flash_attention_bwd_masked_simt,
          "wgmma_masked": tflash.flash_attention_bwd_wgmma_masked}.get(
              design, tflash.flash_attention_bwd)
    assert design != "wgmma_live" or tflash.bwd_route(dt, True) == design
    before = dict(tflash.BWD_LAUNCHES)
    got = fn(q, k, v, o, dout, **kw_fn)
    torch.cuda.synchronize()
    assert tflash.BWD_LAUNCHES == {r: n + (r in tflash.BWD_PAIRS[design])
                                   for r, n in before.items()}
    expect = ref.flash_attention_bwd_ref(q, k, v, o, dout, **kw)
    for g, e in zip(got, expect):
        assert g.dtype == dt and g.shape == e.shape
        _assert_close(g, e, dtype)


@pytest.mark.parametrize("B,Hq,Hkv,S,T,d,causal,win,kind", MASKED_BWD_CASES)
def test_flash_attention_masked_forward_lse(cuda, B, Hq, Hkv, S, T, d, causal, win, kind):
    """The lse the masked wgmma forward writes for the live pair: the plain
    log-sum-exp of the allowed scores in log2 units, -inf exactly on the rows
    with no allowed valid key; the output is the one without lse."""
    q = _randn(cuda, (B, Hq, S, d), torch.bfloat16)
    k, v = (_randn(cuda, (B, Hkv, T, d), torch.bfloat16) for _ in range(2))
    valid = _masked_bwd_valid(B, T, kind, cuda)
    kw = dict(causal=causal, window=win, key_valid=valid)
    out, lse = tflash.flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    expect = ref.flash_attention_lse_ref(q, k, **kw)
    assert lse.dtype == torch.float32 and lse.shape == (B, Hq, S)
    assert torch.equal(torch.isneginf(lse), torch.isneginf(expect))
    fin = torch.isfinite(expect)
    _assert_close_at(lse[fin], expect[fin], (1e-3, 1e-5))
    assert torch.equal(out, tflash.flash_attention(q, k, v, **kw))


def test_tma_kernels_launch_from_a_thread_with_no_cuda_work_yet(cuda):
    """A thread's first CUDA work may be a TMA kernel's tensor-map encode
    (a Python thread, or autograd's backward thread when the op's backward
    is the first node it runs): the encode binds the device's context
    itself, so the masked forward and the live pair launch there."""
    import threading
    B, Hq, Hkv, S, T, d = 2, 4, 2, 128, 300, 64
    q = _randn(cuda, (B, Hq, S, d), torch.bfloat16)
    k, v = (_randn(cuda, (B, Hkv, T, d), torch.bfloat16) for _ in range(2))
    dout = _randn(cuda, (B, Hq, S, d), torch.bfloat16)
    kw = dict(causal=False, key_valid=_key_valid(B, T, [T, 0]))
    torch.cuda.synchronize()
    got = {}

    def run():
        try:
            o, lse = tflash.flash_attention(q, k, v, return_lse=True, **kw)
            got["grads"] = tflash.flash_attention_bwd(q, k, v, o, dout, lse=lse, **kw)
            got["o"] = o
            torch.cuda.synchronize()
        except Exception as exc:   # reported on the test's thread
            got["error"] = exc

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert "error" not in got, got.get("error")
    for g, e in zip(got["grads"], ref.flash_attention_bwd_ref(q, k, v, got["o"], dout, **kw)):
        _assert_close(g, e, "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_under_a_key_mask_on_the_card_has_a_grad_fn(cuda, dtype):
    """Under grad mode a masked call joins the graph: its forward launches
    the masked route and its backward the masked pair of ``bwd_route``, and
    a fully masked row's gradients follow the plain version (dq 0, dO / T
    on every key's dv)."""
    dt = getattr(torch, dtype)
    B, Hq, Hkv, S, T, d = 3, 4, 2, 70, 150, 64
    q = _randn(cuda, (B, Hq, S, d), dt).requires_grad_(True)
    k, v = (_randn(cuda, (B, Hkv, T, d), dt).requires_grad_(True) for _ in range(2))
    dout = _randn(cuda, (B, Hq, S, d), dt)
    valid = _key_valid(B, T, [T, 0, 77])
    ops.reset_launches()
    out = ops.flash_attention(q, k, v, causal=False, key_valid=valid)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == ops.LAUNCHES["flash_attention_bwd"] == 1
    assert ops.ROUTE_LAUNCHES["flash_attention"] == {
        r: int(r == tflash.route(dt, True)) for r in ops.ROUTE_LAUNCHES["flash_attention"]}
    pair = tflash.BWD_PAIRS[tflash.bwd_route(dt, True)]
    assert ops.ROUTE_LAUNCHES["flash_attention_bwd"] == {
        r: int(r in pair) for r in ops.ROUTE_LAUNCHES["flash_attention_bwd"]}
    expect = ref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), out.detach(),
                                         dout, causal=False, key_valid=valid)
    for g, e in zip(grads, expect):
        _assert_close(g, e, dtype)
    assert float(grads[0][1].abs().max()) == 0.0
    with torch.no_grad():
        assert ops.flash_attention(q, k, v, causal=False, key_valid=valid).grad_fn is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gmm_and_the_scans_on_the_card_have_a_grad_fn(cuda, dtype):
    """Under grad mode ``moe_gmm``, ``mamba_scan`` and ``rwkv6_scan`` join the
    graph; their backward launches the new kernels, counted by op and by
    route, and gives the plain versions' gradients; under no_grad nothing
    changes."""
    dt = getattr(torch, dtype)
    g = lambda *s, scale=1.0: (_randn(cuda, s, torch.float32) * scale).to(dt)  # noqa: E731
    ops.reset_launches()
    x, w = g(2, 64, 32), g(2, 32, 16, scale=32 ** -0.5)
    leaves = [t.requires_grad_(True) for t in (x, w)]
    out = ops.moe_gmm(*leaves)
    assert out.grad_fn is not None
    dy = g(*out.shape)
    got = torch.autograd.grad(out, leaves, dy)
    for a, e in zip(got, ref.moe_gmm_bwd_ref(x.detach(), w.detach(), dy)):
        assert a.dtype == dt
        _assert_close_at(a, e, GMM_TOL[dtype])
    assert ops.LAUNCHES["moe_gmm_bwd"] == 1
    r_dx, r_dw = tgmm.bwd_route(dt, 64, 32, 16)
    assert ops.ROUTE_LAUNCHES["moe_gmm_bwd"] == {
        k: int(k in (f"dx_{r_dx}", f"dw_{r_dw}")) for k in ops.ROUTE_LAUNCHES["moe_gmm_bwd"]}

    B, S, di, ds = 2, 40, 96, 16
    mam = [(torch.nn.functional.softplus(_randn(cuda, (B, S, di), torch.float32)) * 0.1).to(dt),
           g(B, S, di, scale=0.1), g(B, S, ds), g(B, S, ds),
           (-torch.exp(_randn(cuda, (di, ds), torch.float32))).to(dt)]
    h0 = _randn(cuda, (B, di, ds), torch.float32)
    leaves = [t.requires_grad_(True) for t in (*mam, h0)]
    y, h_last = ops.mamba_scan(*leaves)
    assert y.grad_fn is not None and h_last.grad_fn is not None
    dy, dh = g(B, S, di), _randn(cuda, (B, di, ds), torch.float32)
    got = torch.autograd.grad((y.float() * dy.float()).sum() + (h_last * dh).sum(), leaves)
    expect = ref.mamba_scan_bwd_ref(*[t.detach() for t in leaves], dy, dh)
    for a, e in zip(got, expect):
        assert a.dtype == e.dtype
        _assert_close_at(a, e, SCAN_TOL["bfloat16" if a.dtype == torch.bfloat16 else "float32"])
    assert ops.LAUNCHES["mamba_scan_bwd"] == 1
    assert ops.ROUTE_LAUNCHES["mamba_scan_bwd"] == {"ring": 1, "ckpt": 0}

    B, T, H, hd = 2, 30, 2, 64
    rw = [g(B, T, H, hd), g(B, T, H, hd, scale=0.3), g(B, T, H, hd, scale=0.3),
          torch.sigmoid(_randn(cuda, (B, T, H, hd), torch.float32) * 0.5 + 2).to(dt),
          g(H, hd, scale=0.1)]
    leaves = [t.requires_grad_(True) for t in rw]
    o, S_last = ops.rwkv6_scan(*leaves)
    assert o.grad_fn is not None and S_last.grad_fn is not None
    do = g(B, T, H, hd)
    got = torch.autograd.grad(o, leaves, do)       # no cotangent of the last state
    expect = ref.rwkv6_scan_bwd_ref(*[t.detach() for t in leaves], None, do, None)
    for a, e in zip(got, expect):
        assert a.dtype == dt
        _assert_close_at(a, e, SCAN_TOL[dtype])
    assert ops.LAUNCHES["rwkv6_scan_bwd"] == 1
    assert ops.ROUTE_LAUNCHES["rwkv6_scan_bwd"] == {"ring": 1, "rows": 0}
    with torch.no_grad():
        assert ops.moe_gmm(x, w).grad_fn is None
        assert ops.rwkv6_scan(*rw)[0].grad_fn is None
    torch.cuda.synchronize()


@pytest.mark.parametrize("design", ["dx", "dx_previous", "dw", "dw_transposed"])
@pytest.mark.parametrize("case", [(4, 100, 96, 136), (2, 64, 256, 64), (3, 200, 96, 72),
                                  (2, 100, 64, 64), (2, 300, 200, 264), (2, 13, 128, 320),
                                  (2, 1, 64, 512)], ids=str)
def test_moe_gmm_bwd_products_alone(cuda, case, design):
    """Each product of the backward on its own entry point in bf16, at the
    bf16 limit: dx and dw on their routes (``wgmma_nt`` and ``wgmma_tn``
    here, ragged C, an odd count of row tiles and a tail of D or F included)
    and the previous designs, dx on the forward's wgmma design and dw over a
    copy of x."""
    E, C, D, F = case
    x = _randn(cuda, (E, C, D), torch.bfloat16)
    w = (_randn(cuda, (E, D, F), torch.float32) * D ** -0.5).to(torch.bfloat16)
    dy = _randn(cuda, (E, C, F), torch.bfloat16)
    ex, ew = ref.moe_gmm_bwd_ref(x, w, dy)
    got = {"dx": lambda: tgmm.moe_gmm_dx(w, dy), "dw": lambda: tgmm.moe_gmm_dw(x, dy),
           "dx_previous": lambda: tgmm.moe_gmm_dx_previous(w, dy),
           "dw_transposed": lambda: tgmm.moe_gmm_dw_transposed(x, dy)}[design]()
    torch.cuda.synchronize()
    assert design != "dw" or tgmm.bwd_route(torch.bfloat16, C, D, F)[1] == "wgmma_tn"
    _assert_close(got, ex if design.startswith("dx") else ew, "bfloat16")


def test_moe_gmm_backward_design_fits_whole_clusters(cuda):
    """The backward's persistent grid: at least one two-block cluster, and
    no more than half the card's SMs, for dw and for dx."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dw in (True, False):
        assert 1 <= tgmm.tn_clusters(dw) <= sms // 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [(4, 100, 96, 130), (2, 64, 256, 64), (3, 200, 96, 72),
                                  (2, 100, 64, 64), (2, 300, 200, 264)], ids=str)
def test_moe_gmm_bwd_kernel(cuda, case, dtype):
    """dx and dw against the plain version: dx at the forward's limits, dw
    (a sum over C) in fp32 at 1e-4 of its largest magnitude."""
    E, C, D, F = case
    dt = getattr(torch, dtype)
    x = _randn(cuda, (E, C, D), dt)
    w = (_randn(cuda, (E, D, F), torch.float32) * D ** -0.5).to(dt)
    dy = _randn(cuda, (E, C, F), dt)
    before = dict(tgmm.BWD_LAUNCHES)
    dx, dw = tgmm.moe_gmm_bwd(x, w, dy)
    torch.cuda.synchronize()
    r_dx, r_dw = tgmm.bwd_route(dt, C, D, F)
    assert tgmm.BWD_LAUNCHES == {k: n + (k in (f"dx_{r_dx}", f"dw_{r_dw}"))
                                 for k, n in before.items()}
    ex, ew = ref.moe_gmm_bwd_ref(x, w, dy)
    assert dx.dtype == dw.dtype == dt
    _assert_close_at(dx, ex, GMM_TOL[dtype])
    if dtype == "float32":
        _assert_sum_close(dw, ew)
    else:
        _assert_close(dw, ew, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,di,ds,with_state", [
    (2, 128, 64, 16, False), (2, 150, 64, 16, True), (3, 77, 333, 16, True),
    (4, 1, 256, 16, True), (2, 40, 96, 5, True), (1, 256, 128, 8, False),
])
def test_mamba_scan_bwd_kernel(cuda, B, S, di, ds, with_state, dtype):
    dt_ = getattr(torch, dtype)
    dt = (torch.nn.functional.softplus(_randn(cuda, (B, S, di), torch.float32)) * 0.1).to(dt_)
    dtx = (_randn(cuda, (B, S, di), torch.float32) * 0.1).to(dt_)
    Bm, Cm = _randn(cuda, (B, S, ds), dt_), _randn(cuda, (B, S, ds), dt_)
    A = (-torch.exp(_randn(cuda, (di, ds), torch.float32))).to(dt_)
    h0 = _randn(cuda, (B, di, ds), torch.float32) if with_state else None
    dh = _randn(cuda, (B, di, ds), torch.float32) if with_state else None
    dy = _randn(cuda, (B, S, di), dt_)
    got = tmamba.mamba_scan_bwd(dt, dtx, Bm, Cm, A, h0, dy, dh)
    torch.cuda.synchronize()
    expect = ref.mamba_scan_bwd_ref(dt, dtx, Bm, Cm, A, h0, dy, dh)
    for name, a, e in zip(("ddt", "ddtx", "dB", "dC", "dA", "dh0"), got, expect):
        assert a.dtype == e.dtype, name
        if a.dtype == torch.bfloat16:
            _assert_close(a, e, "bfloat16")
        elif name in ("dB", "dC", "dA"):
            _assert_sum_close(a, e)
        else:
            _assert_close_at(a, e, SCAN_TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,hd,with_state", [
    (2, 128, 2, 64, False), (1, 64, 4, 32, False), (2, 96, 1, 16, False),
    (2, 150, 2, 64, True), (3, 1, 4, 64, True), (1, 70, 3, 32, True),
])
def test_rwkv6_scan_bwd_kernel(cuda, B, T, H, hd, with_state, dtype):
    dt = getattr(torch, dtype)
    r = _randn(cuda, (B, T, H, hd), dt)
    k, v = ((_randn(cuda, (B, T, H, hd), torch.float32) * 0.3).to(dt) for _ in range(2))
    w = torch.sigmoid(_randn(cuda, (B, T, H, hd), torch.float32) * 0.5 + 2).to(dt)
    u = (_randn(cuda, (H, hd), torch.float32) * 0.1).to(dt)
    S0 = _randn(cuda, (B, H, hd, hd), torch.float32) * 0.3 if with_state else None
    dS = _randn(cuda, (B, H, hd, hd), torch.float32) if with_state else None
    do = _randn(cuda, (B, T, H, hd), dt)
    got = trwkv.rwkv6_scan_bwd(r, k, v, w, u, S0, do, dS)
    torch.cuda.synchronize()
    expect = ref.rwkv6_scan_bwd_ref(r, k, v, w, u, S0, do, dS)
    for name, a, e in zip(("dr", "dk", "dv", "dw", "du", "dS0"), got, expect):
        assert a.dtype == e.dtype, name
        if a.dtype == torch.bfloat16:
            _assert_close(a, e, "bfloat16")
        elif name == "du":
            _assert_sum_close(a, e)
        else:
            _assert_close_at(a, e, SCAN_TOL["float32"])


def _check_scan_grads(names, got, expect, summed):
    for name, a, e in zip(names, got, expect):
        assert a.dtype == e.dtype, name
        if a.dtype == torch.bfloat16:
            _assert_close(a, e, "bfloat16")
        elif name in summed:
            _assert_sum_close(a, e)
        else:
            _assert_close_at(a, e, SCAN_TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("design", ["ring", "ring_chunk8", "ring_no_reuse", "ckpt"])
@pytest.mark.parametrize("B,S,di,ds,with_state", [
    (2, 150, 64, 16, True), (3, 77, 320, 16, True), (4, 1, 256, 16, True),
    (1, 256, 128, 8, False), (2, 40, 96, 16, False),
])
def test_mamba_scan_bwd_designs(cuda, B, S, di, ds, with_state, design, dtype):
    """Each design of the backward on its own entry point (the ring design
    with checkpoints every 16 or 8 steps, with a_t kept from the recompute or
    taken again; the previous ckpt design) against the plain version, S
    ragged, below a chunk and one step, di not a multiple of the block's 64
    channels, and the launch counted by design."""
    dt_ = getattr(torch, dtype)
    assert tmamba.bwd_route(dt_, ds, di) == "ring"
    dt = (torch.nn.functional.softplus(_randn(cuda, (B, S, di), torch.float32)) * 0.1).to(dt_)
    dtx = (_randn(cuda, (B, S, di), torch.float32) * 0.1).to(dt_)
    Bm, Cm = _randn(cuda, (B, S, ds), dt_), _randn(cuda, (B, S, ds), dt_)
    A = (-torch.exp(_randn(cuda, (di, ds), torch.float32))).to(dt_)
    h0 = _randn(cuda, (B, di, ds), torch.float32) if with_state else None
    dh = _randn(cuda, (B, di, ds), torch.float32) if with_state else None
    dy = _randn(cuda, (B, S, di), dt_)
    args = (dt, dtx, Bm, Cm, A, h0, dy, dh)
    before = dict(tmamba.BWD_LAUNCHES)
    got = {"ring": lambda: tmamba.mamba_scan_bwd_ring(*args),
           "ring_chunk8": lambda: tmamba.mamba_scan_bwd_ring(*args, chunk=8),
           "ring_no_reuse": lambda: tmamba.mamba_scan_bwd_ring(*args, reuse=False),
           "ckpt": lambda: tmamba.mamba_scan_bwd_ckpt(*args)}[design]()
    torch.cuda.synchronize()
    counted = "ckpt" if design == "ckpt" else "ring"
    assert tmamba.BWD_LAUNCHES == {k: n + (k == counted) for k, n in before.items()}
    _check_scan_grads(("ddt", "ddtx", "dB", "dC", "dA", "dh0"), got,
                      ref.mamba_scan_bwd_ref(*args), ("dB", "dC", "dA"))


def test_mamba_scan_bwd_ring_shared_memory(cuda):
    """The ring design's shared memory as compiled equals the wrapper's
    model of it, and chunks of 8 leave room for two blocks an SM."""
    for dt in (torch.float32, torch.bfloat16):
        for chunk in tmamba.RING_CHUNKS:
            itemsize = torch.finfo(dt).bits // 8
            assert tmamba.ring_smem_bytes(dt, chunk) == tmamba.ring_smem_bytes_model(itemsize,
                                                                                    chunk)
        assert 2 * (tmamba.ring_smem_bytes(dt, 8) + 1024) <= 228 * 1024


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("design", ["ring", "ring_chunk4", "rows"])
@pytest.mark.parametrize("B,T,H,hd,with_state", [
    (2, 128, 2, 64, False), (1, 64, 4, 32, False), (2, 96, 1, 16, False),
    (2, 150, 2, 64, True), (3, 1, 4, 64, True), (1, 70, 3, 32, True), (1, 13, 2, 16, True),
])
def test_rwkv6_scan_bwd_designs(cuda, B, T, H, hd, with_state, design, dtype):
    """Each design of the backward on its own entry point (the ring design
    with checkpoints every 16 or 4 steps; the previous rows design) against
    the plain version, T ragged, below a chunk and one step, and the launch
    counted by design."""
    dt = getattr(torch, dtype)
    r = _randn(cuda, (B, T, H, hd), dt)
    k, v = ((_randn(cuda, (B, T, H, hd), torch.float32) * 0.3).to(dt) for _ in range(2))
    w = torch.sigmoid(_randn(cuda, (B, T, H, hd), torch.float32) * 0.5 + 2).to(dt)
    u = (_randn(cuda, (H, hd), torch.float32) * 0.1).to(dt)
    S0 = _randn(cuda, (B, H, hd, hd), torch.float32) * 0.3 if with_state else None
    dS = _randn(cuda, (B, H, hd, hd), torch.float32) if with_state else None
    do = _randn(cuda, (B, T, H, hd), dt)
    args = (r, k, v, w, u, S0, do, dS)
    before = dict(trwkv.BWD_LAUNCHES)
    got = {"ring": lambda: trwkv.rwkv6_scan_bwd_ring(*args),
           "ring_chunk4": lambda: trwkv.rwkv6_scan_bwd_ring(*args, chunk=4),
           "rows": lambda: trwkv.rwkv6_scan_bwd_rows(*args)}[design]()
    torch.cuda.synchronize()
    counted = "rows" if design == "rows" else "ring"
    assert trwkv.BWD_LAUNCHES == {k: n + (k == counted) for k, n in before.items()}
    _check_scan_grads(("dr", "dk", "dv", "dw", "du", "dS0"), got,
                      ref.rwkv6_scan_bwd_ref(*args), ("du",))


def test_rwkv6_scan_bwd_ring_shared_memory(cuda):
    """The ring design's shared memory as compiled equals the wrapper's
    model of it, within a block's 227 KB at every hd, dtype and chunk."""
    for dt in (torch.float32, torch.bfloat16):
        for hd in trwkv.HEAD_SIZES:
            for chunk in trwkv.RING_CHUNKS:
                g = trwkv.ring_geometry(1, 1, 1, hd, torch.finfo(dt).bits // 8, chunk)
                assert trwkv.ring_smem_bytes(hd, dt, chunk) == g.smem <= trwkv.SMEM_LIMIT


@pytest.mark.parametrize("arch,n_layers", [("mixtral-8x7b", 2), ("jamba-v0.1-52b", 8),
                                           ("rwkv6-1.6b", 2)])
def test_reduced_family_train_step_card_against_cpu(cuda, arch, n_layers):
    """Two remat steps of reduced float32 mixtral, 8-layer Jamba and RWKV6
    from the same weights and batches on the card and on the CPU: losses and
    grad norms within 1e-4, and every scan and expert matmul, forward and
    backward, on the kernels."""
    import dataclasses

    from repro_torch.config import get_arch, reduced
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import tree_map
    from repro_torch.train import AdamWConfig, DataConfig, SyntheticLM, make_train_step
    from repro_torch.train.optimizer import init_state

    cfg = dataclasses.replace(reduced(get_arch(arch), n_layers=n_layers), dtype="float32")
    p_cpu = T.init_params(cfg, torch.Generator().manual_seed(0))
    it = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=48, batch_size=2)).batches()
    batches = [next(it) for _ in range(2)]
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2), remat=True)
    metrics = {}
    for where in ("cpu", "cuda"):
        params = tree_map(lambda p: p.to(where, copy=True).requires_grad_(True), p_cpu)
        state = init_state(params)
        ops.reset_launches()
        metrics[where] = []
        for b in batches:
            params, state, m = step(params, state,
                                    {k: torch.from_numpy(v).to(where) for k, v in b.items()})
            metrics[where].append({k: float(m[k]) for k in ("loss", "grad_norm")})
    kinds = [k.value for k in cfg.block_kinds()]
    n_moe = sum(k.endswith("_moe") for k in kinds)
    n_scan = sum(k.startswith(("mamba", "rwkv")) for k in kinds)
    scan = "rwkv6_scan" if arch == "rwkv6-1.6b" else "mamba_scan"
    assert ops.LAUNCHES["moe_gmm"] == 2 * 2 * 3 * n_moe
    assert ops.LAUNCHES["moe_gmm_bwd"] == 2 * 3 * n_moe
    assert ops.LAUNCHES[scan] == 2 * 2 * n_scan
    assert ops.LAUNCHES[f"{scan}_bwd"] == 2 * n_scan
    for c, g in zip(metrics["cpu"], metrics["cuda"]):
        for k in c:
            assert g[k] == pytest.approx(c[k], rel=1e-4, abs=1e-4), k


@pytest.mark.parametrize("remat", [True, False])
def test_reduced_train_step_card_against_cpu(cuda, remat):
    """Two steps of reduced float32 qwen3-1.7b from the same weights and
    batches on the card and on the CPU: losses and grad norms within 1e-4,
    and every attention forward and backward on the kernels."""
    import dataclasses

    from repro_torch.config import get_arch, reduced
    from repro_torch.models import transformer as T
    from repro_torch.train import AdamWConfig, DataConfig, SyntheticLM, make_train_step
    from repro_torch.models.layers import tree_map
    from repro_torch.train.optimizer import init_state

    cfg = dataclasses.replace(reduced(get_arch("qwen3-1.7b")), dtype="float32")
    p_cpu = T.init_params(cfg, torch.Generator().manual_seed(0))
    it = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64, batch_size=2)).batches()
    batches = [next(it) for _ in range(2)]
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2), remat=remat)
    metrics = {}
    for where in ("cpu", "cuda"):
        params = tree_map(lambda p: p.to(where, copy=True).requires_grad_(True), p_cpu)
        state = init_state(params)
        ops.reset_launches()
        metrics[where] = []
        for b in batches:
            params, state, m = step(params, state,
                                    {k: torch.from_numpy(v).to(where) for k, v in b.items()})
            metrics[where].append({k: float(m[k]) for k in ("loss", "grad_norm")})
    L = cfg.n_layers
    assert ops.LAUNCHES["flash_attention"] == (2 if remat else 1) * L * 2
    assert ops.ROUTE_LAUNCHES["flash_attention_bwd"] == {
        r: 2 * L * (r in ("bwd_dq", "bwd_dkv")) for r in tflash.BWD_LAUNCHES}
    for c, g in zip(metrics["cpu"], metrics["cuda"]):
        for k in c:
            assert g[k] == pytest.approx(c[k], rel=1e-4, abs=1e-4), k


@pytest.mark.parametrize("remat", [True, False])
def test_reduced_seamless_trains_under_an_enc_mask_card_against_cpu(cuda, remat):
    """Two steps of reduced float32 seamless-m4t under a ragged ``enc_mask``
    with a fully masked row, from the same weights and batches on the card
    and on the CPU: losses and grad norms within 1e-4; the encoder's and the
    decoder's self-attention on the simt pair, the cross-attention on the
    masked route and the masked pair."""
    import dataclasses

    import numpy as np

    from repro_torch.config import get_arch, reduced
    from repro_torch.models import transformer as T
    from repro_torch.train import AdamWConfig, DataConfig, SyntheticLM, make_train_step
    from repro_torch.models.layers import tree_map
    from repro_torch.train.optimizer import init_state

    cfg = dataclasses.replace(reduced(get_arch("seamless-m4t-large-v2")), dtype="float32")
    p_cpu = T.init_params(cfg, torch.Generator().manual_seed(0))
    it = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=40, batch_size=3)).batches()
    rng = np.random.default_rng(0)
    batches = [{**next(it),
                "enc_embeds": rng.standard_normal((3, 150, cfg.d_model)).astype(np.float32),
                "enc_mask": np.arange(150)[None] < np.array([[150], [0], [71]])}
               for _ in range(2)]
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2), remat=remat)
    metrics = {}
    for where in ("cpu", "cuda"):
        params = tree_map(lambda p: p.to(where, copy=True).requires_grad_(True), p_cpu)
        state = init_state(params)
        ops.reset_launches()
        metrics[where] = []
        for b in batches:
            params, state, m = step(params, state,
                                    {k: torch.from_numpy(v).to(where) for k, v in b.items()})
            metrics[where].append({k: float(m[k]) for k in ("loss", "grad_norm")})
    L, E, n = cfg.n_layers, cfg.encdec.encoder_layers, len(batches)
    fwd = 2 if remat else 1
    assert ops.ROUTE_LAUNCHES["flash_attention"] == {
        "simt": n * (E + fwd * L), "masked": n * fwd * L, "wgmma": 0, "wgmma_masked": 0}
    assert ops.ROUTE_LAUNCHES["flash_attention_bwd"] == {
        r: n * ((E + L) * (r in ("bwd_dq", "bwd_dkv")) + L * (r in ("bwd_dq_masked",
                                                                      "bwd_dkv_masked")))
        for r in tflash.BWD_LAUNCHES}
    for c, g in zip(metrics["cpu"], metrics["cuda"]):
        for k in c:
            assert g[k] == pytest.approx(c[k], rel=1e-4, abs=1e-4), k
