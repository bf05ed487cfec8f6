"""The three assigned architectures that ``chip_smoke.py`` first serves and
trains on the card in phases 4h-5j and 11g-11h -- ``phi4-mini-3.8b``,
``phi3.5-moe-42b-a6.6b`` and ``deepseek-67b`` -- against the JAX package
on the CPU, at reduced widths that keep each one's published grouping of
query heads over kv heads: G = 3 (phi4-mini, 24 over 8), G = 4 (phi3.5-moe,
32 over 8, top-2 over 4 experts here) and G = 8 (deepseek, 64 over 8).
``config.reduced`` alone would cap the heads at d_model // 64 and the kv
heads at the heads, G = 1 for all three; ``config.reduced_grouped`` keeps G.

The same weights (the JAX package's draw, handed over by
``params_from_jax``), tokens and ``SyntheticLM`` batches from numpy seeds go
through both packages.  Limits: the prefill and decode logits at atol =
rtol = 3e-5, the fp32 limit of ``tests/test_kernels.py`` (the readings are
below 6e-6); the train step's metrics and gradients at 1e-4, the limit of
``test_train_steps_match_jax`` (the two frameworks sum in other orders,
and a gradient through two layers and the loss carries that further); the
engines' greedy tokens exactly.  Also the routes the card takes at full width, as pure functions."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.config as jconfig  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.train import losses as jlosses  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_loop as jloop  # noqa: E402
from repro.train.checkpoint import _flatten  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch.kernels import decode_attention as tdecode  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import moe_gmm as tgmm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.layers import tree_map  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import data as tdata  # noqa: E402
from repro_torch.train import losses as tlosses  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_loop as tloop  # noqa: E402

LOGITS_TOL = dict(atol=3e-5, rtol=3e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["phi4-mini-3.8b", "phi3.5-moe-42b-a6.6b", "deepseek-67b"]


def grouped_cfgs(arch):
    """The reduced float32 variant of ``arch`` with its published G
    (``config.reduced_grouped``), in the port and in the JAX package."""
    t = dataclasses.replace(tconfig.reduced_grouped(tconfig.get_arch(arch)), dtype="float32")
    j = dataclasses.replace(jconfig.reduced(jconfig.get_arch(arch), d_model=t.d_model),
                            n_heads=t.n_heads, n_kv_heads=t.n_kv_heads, dtype="float32")
    return j, t


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _models(arch, seed):
    jcfg, tcfg = grouped_cfgs(arch)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jparams, params_from_jax(_flatten(jparams), device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small shapes: one intra-op thread, so that torch's pool does not spin
    against the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_reduced_variants_keep_the_published_grouping(arch):
    full = tconfig.get_arch(arch)
    jcfg, tcfg = grouped_cfgs(arch)
    assert tcfg.n_heads // tcfg.n_kv_heads == full.n_heads // full.n_kv_heads
    assert tcfg.resolved_head_dim == 64 and 256 <= tcfg.d_model <= 512
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    if full.moe is not None:
        assert (tcfg.moe.num_experts, tcfg.moe.top_k) == (4, full.moe.top_k)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(arch):
    """A 9-token prompt in a 16-slot cache, then three decode steps."""
    jcfg, tcfg, jparams, tparams = _models(arch, 31)
    B, S = 2, 9
    toks = np.random.default_rng(31).integers(0, jcfg.vocab_size, (B, S + 3))
    jl, jc = JT.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks[:, :S], jnp.int32)},
                        seq_len=16)
    tl, tc = TT.prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks[:, :S])}, seq_len=16)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **LOGITS_TOL)
    assert tc["layers"][0]["k"].shape[3] == tcfg.n_kv_heads     # (layers, B, T, Hkv, d)
    for i in range(3):
        nxt = toks[:, S + i:S + i + 1]
        jl, jc = JT.decode_step(jparams, jcfg, jnp.asarray(nxt, jnp.int32), jnp.int32(S + i), jc)
        tl, tc = TT.decode_step(tparams, tcfg, torch.from_numpy(nxt), S + i, tc)
        np.testing.assert_allclose(_f32(tl), _f32(jl), **LOGITS_TOL, err_msg=f"decode step {i}")
    np.testing.assert_allclose(_f32(tc["layers"][0]["k"]), _f32(jc["layers"][0]["k"]), **LOGITS_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_tokens_equal_jax(arch):
    """Batch 4 through both engines from the JAX engine's weights; for
    phi3.5-moe the decode steps run at capacity 2 for 8 pairs over 4
    experts, so pairs are dropped as in JAX."""
    jcfg, tcfg = grouped_cfgs(arch)
    jeng = JaxEngine(jcfg, batch_slots=4, max_seq_len=32, seed=5)
    params = params_from_jax(_flatten(jeng.params), device="cpu")
    teng = ServingEngine(tcfg, batch_slots=4, max_seq_len=32, device="cpu", params=params)
    prompts = np.random.default_rng(7).integers(0, jcfg.vocab_size, (4, 6)).tolist()
    ops.reset_launches()
    assert teng.generate(prompts, max_new_tokens=6) == jeng.generate(prompts, max_new_tokens=6)
    assert not any(ops.LAUNCHES.values())          # the CPU path launches no kernel


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_jax(arch, remat):
    """One AdamW step from the same weights and batch: the metrics against
    JAX's ``make_train_step``, and the step-1 gradient of every leaf against
    ``jax.grad``, at 1e-4 of the leaf's largest."""
    jcfg, tcfg, jparams, tparams = _models(arch, 0)
    it = tdata.SyntheticLM(tdata.DataConfig(vocab_size=tcfg.vocab_size, seq_len=32,
                                            batch_size=2, seed=3)).batches()
    b = next(it)
    opt_kw = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    jstep = jax.jit(jloop.make_train_step(jcfg, jopt.AdamWConfig(**opt_kw), remat=True))
    _, _, jm = jstep(jparams, jopt.init_state(jparams), {k: jnp.asarray(v) for k, v in b.items()})

    def jax_loss(p):
        logits, aux = JT.forward(p, jcfg, {k: jnp.asarray(v) for k, v in b.items()})
        return jlosses.cross_entropy(logits, jnp.asarray(b["labels"]))["loss"] + aux

    expect = _flatten(jax.grad(jax_loss)(jparams))
    named = list(tckpt._items(tparams))
    for _, p in named:
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    logits, aux = TT.forward(tparams, tcfg, tb, remat=remat)
    loss = tlosses.cross_entropy(logits, tb["labels"])["loss"] + aux
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    assert sorted(expect) == sorted(k for k, _ in named)
    for (key, _), g in zip(named, grads):
        e = expect[key]
        got = np.zeros_like(e) if g is None else g.numpy()
        assert float(np.abs(got - e).max()) <= 1e-4 * float(np.abs(e).max()) + 1e-7, key

    params = tree_map(lambda p: p.detach().requires_grad_(True), tparams)
    step = tloop.make_train_step(tcfg, topt.AdamWConfig(**opt_kw), remat=remat)
    _, _, m = step(params, topt.init_state(params), tb)
    assert set(m) == set(jm)
    for k in ("loss", "nll", "grad_norm", "moe_aux", "lr", "tokens"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), **TOL, err_msg=k)
    if tcfg.moe is not None:
        assert float(m["moe_aux"]) > 0


# ---------------------------------------------------------------------------
# the routes of the full-width runs on the card: pure functions of dtype and shape


@pytest.mark.parametrize("arch,G", [("phi4-mini-3.8b", 3), ("phi3.5-moe-42b-a6.6b", 4),
                                    ("deepseek-67b", 8)])
def test_full_width_attention_routes(arch, G):
    """At the serving traffic (a 1024-slot cache, bf16) every decode step
    takes the split design, every prefill and training step the wgmma
    flash kernel and its wgmma backward pair; fp32 keeps simt."""
    cfg = tconfig.get_arch(arch)
    assert cfg.n_heads // cfg.n_kv_heads == G and cfg.resolved_head_dim == 128
    assert G in tdecode.SPLIT_GROUPS
    assert tdecode.route(torch.bfloat16, G, 1024) == "split"
    assert all(tdecode.route(torch.bfloat16, G, T) == "split" for T in (1, 63, 2 ** 20))
    assert tdecode.route(torch.bfloat16, G, 2 ** 20 + 1) == "simt"
    assert tdecode.route(torch.float32, G, 1024) == "simt"
    assert tflash.route(torch.bfloat16) == "wgmma" and tflash.bwd_route(torch.bfloat16) == "wgmma"


@pytest.mark.parametrize("C,D,F,fwd,bwd", [
    (1, 4096, 6400, "stream", ("stream", "wgmma_tn")),       # decode of 8 slots, gate and up
    (1, 6400, 4096, "stream", ("stream", "wgmma_tn")),       # decode, down
    (640, 4096, 6400, "wgmma", ("wgmma_nt_fwd", "wgmma_tn")),   # 8 x 512 tokens, gate and up
    (640, 6400, 4096, "wgmma", ("wgmma_nt_fwd", "wgmma_tn")),   # down
])
def test_phi35_expert_routes(C, D, F, fwd, bwd):
    """phi3.5-moe's expert matmuls (16 experts, top 2): C = int(1.25 * 2 *
    tokens / 16) is 1 for a decode step of 8 slots and 640 for 8 x 512
    tokens, five 128-row tiles that do not pair, so dx reads w transposed
    on the forward's design."""
    cfg = tconfig.get_arch("phi3.5-moe-42b-a6.6b")
    E, k, cf = cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.capacity_factor
    assert {max(1, int(cf * k * t / E)) for t in (8, 8 * 512)} == {1, 640}
    assert {cfg.d_model, cfg.d_ff} == {D, F}
    assert tgmm.route(torch.bfloat16, C, D, F) == fwd
    assert tgmm.bwd_route(torch.bfloat16, C, D, F) == bwd
