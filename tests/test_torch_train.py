"""The port's training path against the JAX package's on the CPU: the
data stream bit for bit, the loss, AdamW's schedule, clipping, decay and
update, three train steps of reduced float32 models from the same weights
(``params_from_jax``) and batches with remat on and off, a loss that drops,
checkpoints each package reads from the other, the parameter and FLOP
accounting of every registered arch, the input shapes and the launcher.
Losses and grad norms are held at atol = rtol = 1e-4, the limit of
``tests/test_torch_models.py``: the two frameworks sum in other orders."""
import collections
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.config as jconfig  # noqa: E402
from repro.models import flops as jflops  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import data as jdata  # noqa: E402
from repro.train import losses as jlosses  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_loop as jloop  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch.models import flops as tflops  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.layers import tree_leaves, tree_map  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import data as tdata  # noqa: E402
from repro_torch.train import losses as tlosses  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_loop as tloop  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ("qwen3-1.7b", "h2o-danube-3-4b", "mixtral-8x7b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The shapes are small: one intra-op thread, so that torch's thread
    pool does not spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    kw.setdefault("dtype", "float32")
    j = dataclasses.replace(jconfig.reduced(jconfig.get_arch(arch)), **kw)
    t = dataclasses.replace(tconfig.reduced(tconfig.get_arch(arch)), **kw)
    return j, t


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# Data, shapes, accounting

@pytest.mark.parametrize("seed,shard,num_shards", [(0, 0, 1), (7, 1, 4), (3, 2, 3)])
def test_synthetic_lm_batches_are_bit_equal(seed, shard, num_shards):
    dc = dict(vocab_size=1000, seq_len=64, batch_size=3, seed=seed)
    j = jdata.SyntheticLM(jdata.DataConfig(**dc), shard=shard, num_shards=num_shards).batches()
    t = tdata.SyntheticLM(tdata.DataConfig(**dc), shard=shard, num_shards=num_shards).batches()
    for _ in range(3):
        a, b = next(j), next(t)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_input_shapes_equal_jax():
    assert [dataclasses.asdict(s) for s in tconfig.ALL_SHAPES] == \
        [dataclasses.asdict(s) for s in jconfig.ALL_SHAPES]
    assert sorted(tconfig.SHAPES) == sorted(jconfig.SHAPES)
    for name in jconfig.SHAPES:
        assert tconfig.get_shape(name).step.value == jconfig.get_shape(name).step.value
    with pytest.raises(KeyError, match="unknown input shape"):
        tconfig.get_shape("train_1m")


@pytest.mark.parametrize("arch", jconfig.list_archs())
def test_param_and_flop_accounting_equals_jax(arch):
    """From the real parameter trees of both packages (fake tensors in the
    port, ``jax.eval_shape`` in JAX): counts, active counts and the model
    FLOPs of every input shape."""
    j, t = jconfig.get_arch(arch), tconfig.get_arch(arch)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    for js, ts in zip(jconfig.ALL_SHAPES, tconfig.ALL_SHAPES):
        assert tflops.model_flops(t, ts) == jflops.model_flops(j, js)
        assert tflops.attention_flops(t, ts.seq_len, 2) == jflops.attention_flops(j, js.seq_len, 2)


def test_param_count_allocates_nothing():
    """The full deepseek-67b tree (135 GB of bf16) is counted without
    storage."""
    tflops._param_shapes.cache_clear()
    before = torch.cuda.memory_allocated() if torch.cuda.is_available() else 0
    assert tconfig.get_arch("deepseek-67b").param_count() > 6e10
    assert (torch.cuda.memory_allocated() if torch.cuda.is_available() else 0) == before


# ---------------------------------------------------------------------------
# Loss and optimizer

@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_equals_jax(masked):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 7, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.float32) if masked else None
    j = jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                              None if mask is None else jnp.asarray(mask))
    t = tlosses.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                              None if mask is None else torch.from_numpy(mask))
    assert j.keys() == t.keys()
    for k in j:
        np.testing.assert_allclose(_np(t[k]), _np(j[k]), rtol=1e-6, atol=1e-6, err_msg=k)


def test_cross_entropy_runs_in_fp32_for_bf16_logits():
    logits = torch.randn((2, 5, 30), generator=torch.Generator().manual_seed(0))
    labels = torch.randint(0, 30, (2, 5), generator=torch.Generator().manual_seed(1))
    got = tlosses.cross_entropy(logits.bfloat16(), labels)
    expect = tlosses.cross_entropy(logits.bfloat16().float(), labels)
    assert got["loss"].dtype == torch.float32
    torch.testing.assert_close(got["loss"], expect["loss"], atol=0, rtol=0)


@pytest.mark.parametrize("warmup,total,ratio", [(10, 100, 0.1), (1, 4, 0.1), (0, 50, 0.3)])
def test_lr_schedule_equals_jax(warmup, total, ratio):
    jc = jopt.AdamWConfig(lr=1e-3, warmup_steps=warmup, total_steps=total, min_lr_ratio=ratio)
    tc = topt.AdamWConfig(lr=1e-3, warmup_steps=warmup, total_steps=total, min_lr_ratio=ratio)
    for s in range(total + 3):
        j = float(jopt.lr_schedule(jc, jnp.int32(s)))
        t = topt.lr_schedule(tc, torch.tensor(s, dtype=torch.int32))
        assert t.dtype == torch.float32
        np.testing.assert_allclose(float(t), j, rtol=1e-6, atol=0)


def _opt_trees(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "norm": (5,), "stack": (2, 4, 3), "blocks": ((3,), (4, 4))}

    def draw(s, scale):
        if isinstance(s, dict):
            return {k: draw(v, scale) for k, v in s.items()}
        if isinstance(s[0], tuple):
            return tuple(draw(x, scale) for x in s)
        return (rng.standard_normal(s) * scale).astype(dtype)

    return draw(shapes, 1.0), draw(shapes, 3.0)


def _np_tree_to_torch(tree):
    if isinstance(tree, dict):
        return {k: _np_tree_to_torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_np_tree_to_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("clip,decay", [(1.0, 0.1), (1e6, 0.1), (0.5, 0.0)])
def test_apply_updates_equals_jax(clip, decay):
    """Three updates of the same trees: clipping (on and off), decay of the
    matrices only, the fp32 moments, the bias corrections and the schedule."""
    params, _ = _opt_trees(0)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=clip, weight_decay=decay)
    jc, tc = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = _np_tree_to_torch(params)
    js, ts = jopt.init_state(jp), topt.init_state(tp)
    for i in range(3):
        _, grads = _opt_trees(i + 1)
        jp, js, jm = jopt.apply_updates(jc, jp, jax.tree_util.tree_map(jnp.asarray, grads), js)
        tp, ts, tm = topt.apply_updates(tc, tp, _np_tree_to_torch(grads), ts)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        assert int(ts.step) == int(js.step) == i + 1
        for tree_t, tree_j in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
            for a, b in zip(tree_leaves(tree_t), jax.tree_util.tree_leaves(tree_j)):
                np.testing.assert_allclose(_np(a), np.asarray(b), rtol=2e-6, atol=1e-7)


def test_only_matrices_decay_and_bf16_parameters_keep_fp32_moments():
    params = {"w": torch.ones((4, 4), dtype=torch.bfloat16), "b": torch.ones(4)}
    state = topt.init_state(params)
    assert all(m.dtype == torch.float32 for m in tree_leaves(state.mu))
    zero = {"w": torch.zeros((4, 4), dtype=torch.bfloat16), "b": torch.zeros(4)}
    cfg = topt.AdamWConfig(lr=0.1, warmup_steps=0, weight_decay=0.5)
    topt.apply_updates(cfg, params, zero, state)
    assert params["w"].dtype == torch.bfloat16
    assert float(params["w"][0, 0]) < 1.0 and float(params["b"][0]) == 1.0


def test_grad_clipping_bounds_update():
    """The port's copy of ``tests/test_train.py::test_grad_clipping_bounds_update``."""
    params = {"w": torch.ones((4, 4))}
    grads = {"w": torch.full((4, 4), 1e6)}
    cfg = topt.AdamWConfig(grad_clip=1.0, lr=0.1, warmup_steps=0, weight_decay=0.0)
    _, _, m = topt.apply_updates(cfg, params, grads, topt.init_state(params))
    assert m["grad_norm"] > 1e6
    clipped = grads["w"] * torch.clamp(1.0 / m["grad_norm"], max=1.0)
    assert float(topt.global_norm({"w": clipped})) <= 1.0 + 1e-5


# ---------------------------------------------------------------------------
# Train steps against JAX

def _batches(cfg, seq_len, batch, seed, n):
    dc = tdata.DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len, batch_size=batch,
                          seed=seed)
    it = tdata.SyntheticLM(dc).batches()
    return [next(it) for _ in range(n)]


def _jax_trajectory(jcfg, jparams, batches, opt_kw):
    step = jax.jit(jloop.make_train_step(jcfg, jopt.AdamWConfig(**opt_kw), remat=True))
    p, s, out = jparams, jopt.init_state(jparams), []
    for b in batches:
        p, s, m = step(p, s, {k: jnp.asarray(v) for k, v in b.items()})
        out.append({k: float(v) for k, v in m.items()})
    return out


@pytest.fixture(scope="module")
def jax_runs():
    """Per arch: the JAX package's three steps from its own weights, and the
    weights and batches they started from."""
    runs = {}
    opt_kw = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
        batches = _batches(tcfg, 32, 2, 3, 3)
        runs[arch] = (jcfg, tcfg, jparams, batches, opt_kw,
                      _jax_trajectory(jcfg, jparams, batches, opt_kw))
    return runs


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(jax_runs, arch, remat):
    jcfg, tcfg, jparams, batches, opt_kw, expect = jax_runs[arch]
    params = params_from_jax(jckpt._flatten(jparams), device="cpu")
    params = tree_map(lambda p: p.requires_grad_(True), params)
    state = topt.init_state(params)
    step = tloop.make_train_step(tcfg, topt.AdamWConfig(**opt_kw), remat=remat)
    for i, b in enumerate(batches):
        params, state, m = step(params, state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert set(m) == set(expect[i])
        for k in ("loss", "nll", "grad_norm", "moe_aux", "lr", "tokens"):
            np.testing.assert_allclose(float(m[k]), expect[i][k], **TOL,
                                       err_msg=f"{arch} step {i} {k}")
    if arch == "mixtral-8x7b":
        assert all(e["moe_aux"] > 0 for e in expect)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "rwkv6-1.6b", "seamless-m4t-large-v2",
                                  "pixtral-12b"])
def test_gradients_of_the_other_families_match_jax(arch):
    """Jamba, RWKV6, the enc-dec model under a ragged encoder mask, and the
    stub-frontend model (four query heads a kv head, as
    in pixtral-12b) on patch embeddings, on the CPU: every leaf's gradient
    of the loss against ``jax.grad``, held at 1e-4 of the leaf's largest.
    This is the plain path that the card's backward kernels are held
    against (the scans' and the masked flash pairs' in
    ``tests/test_torch_gpu.py``, phases 11c and 11e of ``chip_smoke.py``).
    (Trajectories over several AdamW steps are not held: the first update
    is about the sign of each gradient element, so elements at rounding
    level move by the learning rate in either direction.)"""
    jcfg, tcfg = _cfgs(arch, **({"n_kv_heads": 1} if arch == "pixtral-12b" else {}))
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    b = dict(_batches(tcfg, 16, 2, 3, 1)[0])
    if tcfg.frontend is not None and tcfg.encdec is None:   # patch embeddings for tokens
        rng = np.random.default_rng(6)
        b = {"embeds": rng.standard_normal((2, 16, tcfg.frontend.embed_dim)).astype(np.float32),
             "labels": b["labels"]}
    if tcfg.encdec is not None:
        rng = np.random.default_rng(5)
        b["enc_embeds"] = rng.standard_normal((2, 24, tcfg.frontend.embed_dim)).astype(np.float32)
        b["enc_mask"] = np.arange(24)[None] < np.array([[24], [17]])

    def jax_loss(p):
        logits, aux = JT.forward(p, jcfg, {k: jnp.asarray(v) for k, v in b.items()})
        return jlosses.cross_entropy(logits, jnp.asarray(b["labels"]))["loss"] + aux

    expect = jckpt._flatten(jax.grad(jax_loss)(jparams))
    params = params_from_jax(jckpt._flatten(jparams), device="cpu")
    named = list(tckpt._items(params))
    for _, p in named:
        p.requires_grad_(True)
    logits, aux = TT.forward(params, tcfg, {k: torch.from_numpy(v) for k, v in b.items()},
                             remat=True)
    loss = tlosses.cross_entropy(logits, torch.from_numpy(b["labels"]))["loss"] + aux
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    assert sorted(expect) == sorted(k for k, _ in named)
    for (key, p), g in zip(named, grads):
        e = expect[key]
        got = np.zeros_like(e) if g is None else g.numpy()
        scale = float(np.abs(e).max())
        assert float(np.abs(got - e).max()) <= 1e-4 * scale + 1e-7, key


def test_remat_gives_the_same_gradients_and_unbinds_each_stack_once():
    """One forward and backward with and without remat: equal gradients.
    Each stacked leaf reaches the backward through one ``UnbindBackward``
    (one stack of its layers' gradients), not a select per layer."""
    _, tcfg = _cfgs("qwen3-1.7b", n_layers=3)
    b = _batches(tcfg, 16, 2, 0, 1)[0]
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    grads = []
    for remat in (False, True):
        params = TT.init_params(tcfg, torch.Generator().manual_seed(0))
        params = tree_map(lambda p: p.requires_grad_(True), params)
        logits, _ = TT.forward(params, tcfg, batch, remat=remat)
        loss = tlosses.cross_entropy(logits, batch["labels"])["loss"]
        seen = set()

        def walk(fn):
            if fn is None or fn in seen:
                return
            seen.add(fn)
            for nxt, _ in fn.next_functions:
                walk(nxt)

        walk(loss.grad_fn)
        stacked = {id(p) for p in tree_leaves(params["blocks"])}
        into = collections.Counter(
            type(f).__name__ for f in seen for nxt, _ in f.next_functions
            if type(nxt).__name__ == "AccumulateGrad" and id(nxt.variable) in stacked)
        assert into == {"UnbindBackward0": len(stacked)}
        grads.append(torch.autograd.grad(loss, tree_leaves(params)))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_loss_decreases_on_synthetic_data():
    """The port's copy of ``tests/test_train.py::test_loss_decreases_on_synthetic_data``."""
    _, cfg = _cfgs("h2o-danube-3-4b")
    dc = tdata.DataConfig(vocab_size=cfg.vocab_size, seq_len=32, batch_size=4, seed=1)
    res = tloop.train(cfg, tdata.SyntheticLM(dc).batches(), steps=25,
                      opt_cfg=topt.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=25),
                      log_every=24, device="cpu")
    hist = res["history"]
    assert [h["step"] for h in hist] == [0, 24]
    assert set(hist[0]) == {"loss", "nll", "ppl_proxy", "tokens", "moe_aux", "grad_norm",
                            "lr", "step", "elapsed_s"}
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.8


def test_train_refuses_the_card_it_does_not_have():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, cfg = _cfgs("qwen3-1.7b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tloop.train(cfg, iter(_batches(cfg, 8, 1, 0, 1)), steps=1)


# ---------------------------------------------------------------------------
# Checkpoints

def _jax_state(dtype):
    jcfg, _ = _cfgs("qwen3-1.7b", dtype=dtype)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    js = jopt.init_state(jparams)
    rng = np.random.default_rng(0)
    js = jopt.AdamWState(jnp.int32(5), *(jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape), jnp.float32), t)
        for t in (js.mu, js.nu)))
    return jparams, js


def _to_torch_state(js):
    return topt.AdamWState(torch.tensor(int(js.step), dtype=torch.int32),
                           params_from_jax(jckpt._flatten(js.mu), device="cpu"),
                           params_from_jax(jckpt._flatten(js.nu), device="cpu"))


def _assert_same(torch_tree, jax_tree):
    tl, jl = tree_leaves(torch_tree), jax.tree_util.tree_leaves(jax_tree)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        b = np.asarray(b)
        if b.dtype.name == "bfloat16":
            assert a.dtype == torch.bfloat16
            np.testing.assert_array_equal(a.view(torch.int16).numpy(), b.view(np.int16))
        else:
            np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_port_restores_jax_checkpoints_exactly(tmp_path, dtype):
    jparams, js = _jax_state(dtype)
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, jparams, js, step=17)
    tparams, tstate = params_from_jax(jckpt._flatten(jparams), device="cpu"), _to_torch_state(js)
    template = tree_map(torch.zeros_like, tparams)
    opt_template = tree_map(torch.zeros_like, tstate)
    p2, o2, step = tckpt.restore(path, template, opt_template)
    assert step == 17 and int(o2.step) == 5 and o2.step.dtype == torch.int32
    _assert_same(p2, jparams)
    _assert_same(o2.mu, js.mu)
    _assert_same(o2.nu, js.nu)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoints_are_the_jax_format(tmp_path, dtype):
    """The port writes the JAX package's file of the same trees: the same
    keys, dtypes and bytes of every array and the same metadata."""
    jparams, js = _jax_state(dtype)
    tparams, tstate = params_from_jax(jckpt._flatten(jparams), device="cpu"), _to_torch_state(js)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jckpt.save(jpath, jparams, js, step=3, extra={"arch": "qwen3"})
    tckpt.save(tpath, tparams, tstate, step=3, extra={"arch": "qwen3"})
    with np.load(jpath) as jz, np.load(tpath) as tz:
        assert sorted(jz.files) == sorted(tz.files)
        for k in jz.files:
            assert jz[k].dtype == tz[k].dtype and jz[k].shape == tz[k].shape, k
            assert jz[k].tobytes() == tz[k].tobytes(), k
    if dtype == "float32":          # the JAX package restores the port's file
        p2, o2, step = jckpt.restore(tpath, jparams, js)
        assert step == 3
        for a, b in zip(jax.tree_util.tree_leaves((p2, o2)),
                        jax.tree_util.tree_leaves((jparams, js))):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        # The JAX package's restore casts no two-byte raw array to bfloat16,
        # so it refuses its own bf16 file as it refuses the port's, which is
        # the same file; the port restores both (the test above).
        for path in (jpath, tpath):
            with pytest.raises(ValueError, match="No cast function"):
                jckpt.restore(path, jparams, js)


def test_port_checkpoint_roundtrip_through_the_trainer(tmp_path):
    """``train`` writes a checkpoint at its period; ``restore`` gives back
    the trained weights and the optimizer state exactly."""
    _, cfg = _cfgs("qwen3-1.7b")
    path = str(tmp_path / "ckpt.npz")
    res = tloop.train(cfg, iter(_batches(cfg, 16, 2, 0, 2)), steps=2, log_every=1,
                      checkpoint_path=path, checkpoint_every=2, device="cpu")
    template = tree_map(torch.zeros_like, res["params"])
    p2, o2, step = tckpt.restore(path, template, tree_map(torch.zeros_like,
                                                               res["opt_state"]))
    assert step == 2 and int(o2.step) == 2
    for a, b in zip(tree_leaves((p2, o2)), tree_leaves((res["params"],
                                                                  res["opt_state"]))):
        torch.testing.assert_close(a, b.detach(), atol=0, rtol=0)


# ---------------------------------------------------------------------------
# Launcher

def test_the_launcher_trains_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen3-1.7b",
                        "--smoke", "--device", "cpu", "--steps", "3"],
                       capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "final: loss" in r.stdout and "on cpu" in r.stdout


def test_the_training_example_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, str(ROOT / "examples" / "train_small_torch.py"),
                        "--steps", "1", "--seq-len", "16", "--batch", "1", "--device", "cpu"],
                       capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "training demo-100m" in r.stdout and "loss " in r.stdout
