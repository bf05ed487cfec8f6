"""The training step that the card captures as one CUDA graph, on the CPU
against the JAX package, and the AdamW kernel's wrapper.

On the CPU there is no graph: the trainer runs the step function the card
captures (``make_train_step`` with the step counter advanced in place and
the remat recompute without a saved RNG state), eagerly.  What the CPU can
show: that step equals the JAX package's jitted ``make_train_step`` over
three steps in each family, at ``tests/test_torch_train.py``'s limits
(atol = rtol = 1e-4: the two frameworks sum in other orders); it reads no
device value on the host (run on fake tensors, where a ``.item()``, a
``.tolist()`` or a ``bool`` of a tensor raises); the counter is one tensor
advanced in place.  The AdamW kernel's wrapper: its tables cover every
element of every leaf once with the right flags, and a numpy model of the
kernel's fixed-order sum of squares gives the global norm.  Capture, replay
and the kernel itself run on the card only: ``tests/test_torch_gpu.py``.
"""
import ctypes
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.config as jconfig  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_loop as jloop  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch.kernels import adamw as tadamw  # noqa: E402
from repro_torch.kernels import ops, ref, trace_ops  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.layers import tree_map  # noqa: E402
from repro_torch.train import data as tdata  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_loop as tloop  # noqa: E402
from repro_torch.train.step_graph import TrainGraph  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)        # tests/test_torch_train.py
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=3)
B, SEQ, FRAMES = 2, 16, 24
#: family -> (architecture, config overrides): h2o's window cut to 8 tokens,
#: under the 16-token sequence, so that it binds; pixtral at its G = 4
FAMILIES = {
    "dense": ("qwen3-1.7b", {}),
    "windowed": ("h2o-danube-3-4b", {"sliding_window": 8}),
    "moe": ("mixtral-8x7b", {}),
    "jamba": ("jamba-v0.1-52b", {}),
    "rwkv6": ("rwkv6-1.6b", {}),
    "seamless": ("seamless-m4t-large-v2", {}),
    "pixtral": ("pixtral-12b", {"n_kv_heads": 1}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(family):
    arch, kw = FAMILIES[family]
    j = dataclasses.replace(jconfig.reduced(jconfig.get_arch(arch)), dtype="float32", **kw)
    t = dataclasses.replace(tconfig.reduced(tconfig.get_arch(arch)), dtype="float32", **kw)
    return j, t


def _batches(cfg, n, seed=3):
    """``n`` numpy batches of the family's inputs: SyntheticLM tokens and
    labels; an enc-dec model's frames under a ragged ``enc_mask``; a
    frontend model's patch embeddings in place of tokens."""
    it = tdata.SyntheticLM(tdata.DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                            batch_size=B, seed=seed)).batches()
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = dict(next(it))
        if cfg.encdec is not None:
            b["enc_embeds"] = rng.standard_normal((B, FRAMES, cfg.frontend.embed_dim)
                                                  ).astype(np.float32)
            b["enc_mask"] = np.arange(FRAMES)[None] < np.array([[FRAMES], [17]])
        elif cfg.frontend is not None:
            b = {"embeds": rng.standard_normal((B, SEQ, cfg.frontend.embed_dim)
                                               ).astype(np.float32),
                 "labels": b["labels"]}
        out.append(b)
    return out


# ---------------------------------------------------------------------------
# The captured step, run eagerly, against JAX's jitted step

#: held step by step: each step from the JAX run's weights and moments
#: before it.  Reduced RWKV6's grad norm at step 3 moves by 2.2e-3 of itself
#: on one framework alone when the weights move by 1e-6 of themselves
#: (tests/test_torch_family_bwd.py::test_trajectory_sensitivity_to_a_weight_nudge),
#: so its free-running trajectories part past 1e-4 by rounding alone, as on
#: the card (chip_smoke.py's TRAIN_FAMILY_RESYNC)
RESYNC = ("rwkv6",)


def _to_torch(jtree):
    return params_from_jax(jckpt._flatten(jtree), device="cpu")


@pytest.mark.parametrize("family", list(FAMILIES))
def test_captured_step_equals_jax_jitted_step(family):
    """Three steps of the step the card captures, from the JAX package's
    weights and the same batches, against ``jax.jit(make_train_step)``:
    every metric of every step within 1e-4; free-running but for
    ``RESYNC``."""
    jcfg, tcfg = _cfgs(family)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    batches = _batches(tcfg, 3)
    jstep = jax.jit(jloop.make_train_step(jcfg, jopt.AdamWConfig(**OPT), remat=True))
    jp, js, expect, before = jparams, jopt.init_state(jparams), [], []
    for b in batches:
        before.append((jp, js))
        jp, js, m = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        expect.append({k: float(v) for k, v in m.items()})

    params = tree_map(lambda p: p.requires_grad_(True), _to_torch(jparams))
    state = topt.init_state(params)
    step = tloop.make_train_step(tcfg, topt.AdamWConfig(**OPT), remat=True)
    for i, b in enumerate(batches):
        if family in RESYNC and i:
            jp_i, js_i = before[i]
            params = tree_map(lambda p: p.requires_grad_(True), _to_torch(jp_i))
            state = topt.AdamWState(torch.tensor(int(js_i.step), dtype=torch.int32),
                                    _to_torch(js_i.mu), _to_torch(js_i.nu))
        params, state, m = step(params, state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert set(m) == set(expect[i])
        for k in expect[i]:
            np.testing.assert_allclose(float(m[k]), expect[i][k], **TOL,
                                       err_msg=f"{family} step {i + 1} {k}")
    assert int(state.step) == int(js.step) == 3


def test_step_counter_advances_in_place():
    """``apply_updates`` advances the counter it was given, as a replay
    needs: after three steps ``state.step`` is the tensor ``init_state``
    made, at 3, and each step's learning rate is the schedule's at the
    counter before it."""
    _, tcfg = _cfgs("dense")
    params = tree_map(lambda p: p.requires_grad_(True),
                      TT.init_params(tcfg, torch.Generator().manual_seed(0)))
    state = topt.init_state(params)
    counter = state.step
    opt = topt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=5)
    step = tloop.make_train_step(tcfg, opt)
    for i, b in enumerate(_batches(tcfg, 3)):
        params, state, m = step(params, state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert state.step is counter and int(counter) == i + 1
        assert float(m["lr"]) == float(topt.lr_schedule(opt, i))


def _fake_train_step(cfg, step_fn=None):
    """One train step of ``cfg`` on fake tensors (shapes and dtypes, no
    data): a step that reads a device value on the host raises
    ``DataDependentOutputException`` here, as it would break a capture on
    the card.  Returns the step's metrics."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    params = TT.init_params(cfg, torch.Generator().manual_seed(0))
    b = _batches(cfg, 1)[0]
    step_fn = step_fn or tloop.make_train_step(cfg, topt.AdamWConfig(**OPT))
    with FakeTensorMode():
        p = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype).requires_grad_(True),
                     params)
        batch = {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype)
                 for k, v in b.items()}
        _, state, m = step_fn(p, topt.init_state(p), batch)
        assert state.step.shape == ()
    return m


@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_step_reads_no_device_value_on_the_host(family):
    _, tcfg = _cfgs(family)
    m = _fake_train_step(tcfg)
    assert {"loss", "nll", "grad_norm", "lr", "moe_aux"} <= set(m)
    assert all(v.shape == () for v in m.values())


def test_fake_train_run_sees_a_host_sync(monkeypatch):
    """The check above has teeth: a schedule that reads the counter on the
    host raises on fake tensors."""
    from torch._subclasses.fake_tensor import DataDependentOutputException

    schedule = topt.lr_schedule
    monkeypatch.setattr(topt, "lr_schedule", lambda cfg, step: schedule(cfg, int(step)))
    with pytest.raises(DataDependentOutputException):
        _fake_train_step(_cfgs("dense")[1])


def test_train_on_the_cpu_runs_the_step_eagerly():
    """On the CPU there is no graph: ``train`` takes the steps of
    ``make_train_step`` eagerly, its history is theirs, and a graph asks
    for a card."""
    _, tcfg = _cfgs("dense")
    run = tloop.train(tcfg, iter(_batches(tcfg, 3)), 3, seed=0, log_every=1, device="cpu")
    params = TT.init_params(tcfg, torch.Generator().manual_seed(0))
    params = tree_map(lambda p: p.requires_grad_(True), params)
    state = topt.init_state(params)
    step = tloop.make_train_step(tcfg, topt.AdamWConfig(total_steps=3))
    for h, batch in zip(run["history"], _batches(tcfg, 3)):
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        params, state, metrics = step(params, state, batch)
        assert {k: v for k, v in h.items() if k not in ("step", "elapsed_s")} == \
            {k: float(v) for k, v in metrics.items()}
    assert int(run["opt_state"].step) == int(state.step) == 3
    with pytest.raises(ValueError, match="CUDA"):
        TrainGraph(step, run["params"], run["opt_state"], {})


# ---------------------------------------------------------------------------
# The AdamW kernel's wrapper: tables, flags, the fixed-order norm

NUMELS = ([0, 1, 7, 8, 9, tadamw.TILE - 1, tadamw.TILE, tadamw.TILE + 1, 3 * tadamw.TILE + 5]
          + [(37 * i) % 4099 for i in range(130)])


def test_table_layout_matches_the_source():
    assert ctypes.sizeof(tadamw.Table) == tadamw.TABLE_BYTES
    assert tadamw.TILE == tadamw.THREADS * tadamw.VEC


def _tile_span(starts, numels, tile):
    """The kernels' walk (csrc/adamw.cu): tile ``tile`` of a table covers
    elements ``lo`` to ``hi`` of its leaf ``leaf``: (leaf, lo, hi), the block
    moving forward through ``starts`` to find the leaf."""
    leaf = 0
    while tile >= starts[leaf + 1]:
        leaf += 1
    lo = (tile - starts[leaf]) * tadamw.TILE
    return leaf, lo, min(lo + tadamw.TILE, numels[leaf])


def test_tables_cover_every_element_once():
    """Every launch's table holds at most ``MAX_LEAVES`` leaves, each
    non-empty leaf is in one table, and the kernels' walk (block b takes
    tiles b, b + grid, ...; thread t of a tile ``VEC`` elements from
    ``lo + VEC t``, short of the leaf's end) touches every element of every
    leaf once."""
    tables = tadamw.split_tables(NUMELS)
    assert all(0 < len(t) <= tadamw.MAX_LEAVES for t in tables) and len(tables) == 3
    assert sorted(i for t in tables for i in t) == [i for i, n in enumerate(NUMELS) if n]
    seen = [np.zeros(n, np.int64) for n in NUMELS]
    for leaves in tables:
        numels = [NUMELS[i] for i in leaves]
        starts = tadamw.tile_starts(numels)
        grid = tadamw.grid_size(starts[-1], sms=3)
        assert grid == min(starts[-1], 3 * tadamw.BLOCKS_PER_SM)
        for block in range(grid):
            for tile in range(block, starts[-1], grid):
                leaf, lo, hi = _tile_span(starts, numels, tile)
                for t in range(tadamw.THREADS):
                    e = lo + tadamw.VEC * t
                    seen[leaves[leaf]][e:min(e + tadamw.VEC, hi)] += 1
    assert all((s == 1).all() for s in seen)


def test_leaf_flags():
    """bf16 by the parameter's dtype; decay for ndim >= 2 only; the vector
    path only where all four tensors are 16-byte aligned."""
    def leaf(shape, dtype):
        return (torch.zeros(shape, dtype=dtype), torch.zeros(shape, dtype=dtype),
                torch.zeros(shape), torch.zeros(shape))

    A = tadamw.FLAG_ALIGNED
    assert tadamw.leaf_flags(*leaf((4, 8), torch.bfloat16)) == tadamw.FLAG_BF16 | \
        tadamw.FLAG_DECAY | A
    assert tadamw.leaf_flags(*leaf((2, 3, 8), torch.float32)) == tadamw.FLAG_DECAY | A
    assert tadamw.leaf_flags(*leaf((64,), torch.float32)) == A
    p, g, m, v = leaf((65,), torch.float32)
    assert tadamw.leaf_flags(p[1:], g[1:], m[1:], v[1:]) == 0


def _block_sum(x):
    """``block_sum`` of csrc/adamw.cu over the last axis (the block's
    threads): a shuffle-down tree in each warp, then over the warps'
    sums, padded to 32 with zeros."""
    def warp_tree(v):                       # (..., 32) -> (...,): lane 0's sum
        for o in (16, 8, 4, 2, 1):
            v = v[..., :o] + v[..., o:2 * o]
        return v[..., 0]

    warps = warp_tree(x.reshape(*x.shape[:-1], -1, 32))
    pad = np.zeros((*warps.shape[:-1], 32 - warps.shape[-1]))
    return warp_tree(np.concatenate([warps, pad], axis=-1))


def _kernel_norm(grads, sms):
    """A numpy model of ``adamw_sumsq``: each thread's 8 squares summed by
    fused multiply-adds in fp32, its tiles' sums added in fp64 in the order
    it walks them, each block's threads by ``block_sum``, one partial a
    block, table after table; then the norm block, 1024 threads each adding
    every 1024th partial in order, by ``block_sum``."""
    partials = []
    for leaves in tadamw.split_tables([g.size for g in grads]):
        padded = [np.pad(grads[i].astype(np.float32),
                         (0, tadamw.leaf_tiles(grads[i].size) * tadamw.TILE - grads[i].size))
                  for i in leaves]
        x = np.concatenate(padded).reshape(-1, tadamw.THREADS, tadamw.VEC).astype(np.float64)
        s = np.zeros(x.shape[:2], np.float32)
        for k in range(tadamw.VEC):
            s = (x[..., k] * x[..., k] + s).astype(np.float32)
        grid = tadamw.grid_size(x.shape[0], sms)
        acc = np.stack([np.cumsum(s[b::grid].astype(np.float64), axis=0)[-1]
                        for b in range(grid)])
        partials.extend(_block_sum(acc))
    partials = np.array(partials)
    n = -(-partials.size // 1024) * 1024
    per_thread = np.cumsum(np.pad(partials, (0, n - partials.size)).reshape(-1, 1024), axis=0)[-1]
    return np.float32(np.sqrt(_block_sum(per_thread)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fixed_order_norm_model_equals_global_norm(dtype):
    rng = np.random.default_rng(0)
    grads = [torch.from_numpy((rng.standard_normal(n) * (1 + i % 5)).astype(np.float32)
                              ).to(dtype) for i, n in enumerate(NUMELS)]
    expect = float(topt.global_norm(tuple(grads)))
    got = _kernel_norm([g.float().numpy() for g in grads], sms=2)
    np.testing.assert_allclose(got, expect, rtol=1e-5)
    assert _kernel_norm([g.float().numpy() for g in grads], sms=2) == got


def test_wrapper_takes_only_cuda_tensors():
    p = [torch.zeros(8)]
    with pytest.raises(ValueError, match="CUDA"):
        tadamw.adamw_update(p, p, p, p, torch.zeros((), dtype=torch.int32), torch.zeros(()),
                            b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=1.0)


def test_dry_run_ops_compute_the_plain_update():
    """The dry run's single ops (``trace_ops``) on CPU tensors: the sum of
    squares and a leaf's new (p, m, v) are the plain version's."""
    rng = np.random.default_rng(1)
    hyper = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=1.0)
    for shape in ((6, 5), (7,)):
        p, g, m, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                      for _ in range(4))
        v = v.abs()
        step, lr = torch.tensor(2, dtype=torch.int32), torch.tensor(1e-2)
        gnorm = ref.global_norm([g])
        assert torch.equal(trace_ops.adamw_sumsq(g).sqrt(), gnorm)
        scale = torch.clamp(1.0 / (gnorm + 1e-9), max=1.0)
        b1c, b2c = 1 - 0.9 ** step.float(), 1 - 0.95 ** step.float()
        got = trace_ops.adamw_leaf(p, g, m, v, scale, lr, b1c, b2c, 0.9, 0.95, 1e-8,
                                   0.1 if p.dim() >= 2 else 0.0)
        want = [t.clone() for t in (p, m, v)]
        ops.adamw_update([want[0]], [g], [want[1]], [want[2]], step, lr, **hyper)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)
