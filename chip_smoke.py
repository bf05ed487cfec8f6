#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``.  Phases, each of which fails the run:

1. device and toolchain: versions, the card's name and power limit, SMs;
2. build: the attention and AES kernels from ``src/repro_torch/csrc`` into
   ``build/kernels`` (one ``nvcc`` per source, in parallel), with nvcc's
   ``-Xptxas -v`` report;
3. each kernel against its plain PyTorch version on the card, over the
   sweep of ``tests/test_kernels.py`` and at the main path's shapes in
   bf16, then timed there with CUDA events, L2 flushed before every
   launch.  Kernels and plain versions both compute in fp32 and round
   once, so fp32 is held at atol = rtol = 3e-5 and bf16 at atol 1e-3,
   rtol 1e-2 (one bf16 ulp is at most 2**-7 of |x|);
4. a reduced ``qwen3-1.7b`` at float32 on the CPU (plain versions) and on
   the card (kernels) with the same weights: equal greedy tokens, and
   logits within atol/rtol 1e-4;
5. full-width ``qwen3-1.7b`` (bf16, random weights from a seed) served by
   ``ServingEngine``: 8 prompts of 512 tokens, 32 new tokens each, with the
   kernel launch counts of that run checked against the layer count;
6. the AES-128-CTR kernel: the FIPS-197 C.1 known answer, bit-exact
   agreement with its plain version on the card over N, nonces (one across
   the 2**31 sign wrap) and two keys, a round trip, its launch count, and
   its time at the function's 38 blocks (600 B) and at 2**20 blocks;
7. the FaaS path through the port's faasd runtime: the AES function's body
   (600 B to the card, the kernel, back, synchronised) timed on the card as
   ``work_us``, then deployed with the full-width model endpoint of phase 5
   on containerd and on junctiond.  Those latencies are simulated on the
   host from the paper's host costs; only ``work_us`` is measured here.

The line before the last is a JSON object with one entry per kernel; the
last is ``{"ok": true, "device": {...}}``.  It imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12           # dense tensor cores; the timed shapes are bf16
SMEM_LOOKUPS_PER_CLOCK = 32        # one conflict-free 32-lane shared-memory load per SM

FLASH_SWEEP = [  # B, Hq, Hkv, S, T, d, causal, window (tests/test_kernels.py)
    (2, 4, 2, 128, 128, 64, True, None),
    (1, 8, 2, 96, 96, 64, True, 32),
    (2, 2, 2, 64, 192, 32, True, None),
    (1, 4, 4, 128, 128, 128, False, None),
    (1, 2, 1, 257, 257, 64, True, None),
]
DECODE_SWEEP = [(2, 8, 2, 300, 64), (1, 4, 4, 512, 128), (3, 16, 8, 257, 64)]
FLASH_MAIN = (8, 16, 8, 512, 512, 128, True, None)
DECODE_MAIN = (8, 16, 8, 1024, 128)
PROMPT_LEN, NEW_TOKENS, SLOTS, MAX_SEQ = 512, 32, 8, 1024
PROFILED_STEPS = 4
AES_SWEEP_N = (1, 38, 40, 4096, 2**20)
AES_NONCES = (0, 7, 2**31 - 20)
AES_FN_BLOCKS, AES_BATCH_BLOCKS = 38, 2**20   # 600 B; 16 MiB of plaintext
AES_LOOKUPS_PER_BLOCK = 160                   # 16 S-box lookups in each of 10 rounds
FIPS197_C1 = ("000102030405060708090a0b0c0d0e0f", "00112233445566778899aabbccddeeff",
              "69c4e0d86a7b0430d8cdb78070b4c55a")    # key, plaintext, ciphertext
BODY_CALLS = 200
AES_REQUESTS, MODEL_REQUESTS = 100, 50
TOL = {"float32": (3e-5, 3e-5), "bfloat16": (1e-3, 1e-2)}   # (atol, rtol)


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def sh(*cmd: str) -> str:
    return subprocess.run(cmd, check=True, capture_output=True, text=True).stdout.strip()


def check_close(name: str, out, expect, tol) -> float:
    """Max |out - expect|; raises unless every element is finite and within
    atol + rtol * |expect|, ``tol`` = (atol, rtol)."""
    atol, rtol = tol
    out, expect = out.float(), expect.float()
    err = (out - expect).abs()
    bad = err > atol + rtol * expect.abs()
    if not bool(out.isfinite().all()) or bool(bad.any()):
        raise AssertionError(f"{name}: max |diff| {float(err.max()):.3g} over "
                             f"atol {atol}, rtol {rtol}")
    return float(err.max())


def time_ms(torch, fn, iters: int, flush) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, L2 flushed
    before each (outside the timed span)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def profile_decode(torch, T, eng, cfg, prompts, dev):
    """Device time and host wall time of one decode step at the serving
    shapes, both over the same ``PROFILED_STEPS`` profiled steps (the wall
    time includes the profiler's own cost), and the kernels that take most
    of the device time.  Device time is None when the profiler sees no
    kernel."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        lg, caches = T.prefill(eng.params, cfg, {"tokens": torch.tensor(prompts, device=dev)},
                               seq_len=MAX_SEQ)
        tok = lg.argmax(-1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(PROFILED_STEPS):
                lg, caches = T.decode_step(eng.params, cfg, tok, PROMPT_LEN + i, caches)
                tok = lg.argmax(-1)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0) / PROFILED_STEPS
    kernels = [(e.key, e.self_device_time_total) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(us for _, us in kernels)
    if not total:
        return None, wall_us, []
    top = sorted(kernels, key=lambda kv: -kv[1])[:6]
    return total / PROFILED_STEPS, wall_us, [(k, us / PROFILED_STEPS) for k, us in top]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.config import get_arch, reduced
    from repro_torch.core import FaasdRuntime, FunctionSpec, Simulator, run_sequential
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.aes_ctr import aes_ctr as aes_kernel
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import tree_to
    from repro_torch.serving import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    # -- 1 ------------------------------------------------------------------
    phase("1 device and toolchain")
    smi = sh("nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader")
    smi = smi.splitlines()[0]
    sm_clock_hz = 1e6 * float(sh("nvidia-smi", "--query-gpu=clocks.max.sm",
                                 "--format=csv,noheader,nounits").splitlines()[0])
    props = torch.cuda.get_device_properties(0)
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}")
    print(sh(_build.nvcc(), "--version").splitlines()[-1])
    print(smi)
    print(f"{props.name}: {props.multi_processor_count} SMs, "
          f"{props.total_memory / 2**30:.1f} GiB, max SM clock {sm_clock_hz / 1e6:.0f} MHz")

    # -- 2 ------------------------------------------------------------------
    phase("2 build")
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"built {sorted(logs) or 'nothing (up to date)'} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas" in line and ("registers" in line or "spill" in line
                                    or "Compiling" in line):
                print(f"  {name}: {line.strip()}")

    # -- 3 ------------------------------------------------------------------
    phase("3 kernels against their plain versions")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def flash_case(case, dt):
        B, Hq, Hkv, S, Tk, d, causal, win = case
        q, k, v = randn(B, Hq, S, d, dtype=dt), randn(B, Hkv, Tk, d, dtype=dt), \
            randn(B, Hkv, Tk, d, dtype=dt)
        return (q, k, v), dict(causal=causal, window=win)

    def decode_case(case, dt, valid=None):
        B, Hq, Hkv, Tk, d = case
        q, k, v = randn(B, Hq, d, dtype=dt), randn(B, Tk, Hkv, d, dtype=dt), \
            randn(B, Tk, Hkv, d, dtype=dt)
        if valid is None:
            valid = torch.rand((B, Tk), generator=gen, device=dev) < 0.8
            valid[:, 0] = True
        return (q, k, v, valid), {}

    kernels = {
        "flash_attention": dict(op=ops.flash_attention, plain=ref.flash_attention_ref,
                                make=flash_case, sweep=FLASH_SWEEP),
        "decode_attention": dict(op=ops.decode_attention, plain=ref.decode_attention_ref,
                                 make=decode_case, sweep=DECODE_SWEEP),
    }
    for name, kd in kernels.items():
        for case in kd["sweep"]:
            for dname, dt in dtypes.items():
                args, kw = kd["make"](case, dt)
                out = kd["op"](*args, **kw)
                torch.cuda.synchronize()
                err = check_close(f"{name}{case} {dname}", out, kd["plain"](*args, **kw),
                                  TOL[dname])
                print(f"  {name} {case} {dname}: max |diff| {err:.3g} "
                      f"(atol, rtol {TOL[dname]})")

    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    records = {}
    # flash at the prefill of the main path
    B, Hq, Hkv, S, Tk, d, causal, win = FLASH_MAIN
    (q, k, v), kw = flash_case(FLASH_MAIN, torch.bfloat16)
    out = ops.flash_attention(q, k, v, **kw)
    err = check_close(f"flash_attention{FLASH_MAIN}", out,
                      ref.flash_attention_ref(q, k, v, **kw), TOL["bfloat16"])
    pairs = int(torch.tril(torch.ones(S, Tk, dtype=torch.bool), Tk - S).sum())
    kq, vq = k.repeat_interleave(Hq // Hkv, 1), v.repeat_interleave(Hq // Hkv, 1)
    records["flash_attention"] = dict(
        err=err,
        ms=time_ms(torch, lambda: ops.flash_attention(q, k, v, **kw), 20, flush),
        plain_ms=time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, **kw), 5, flush),
        library_ms=time_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            q, kq, vq, is_causal=True), 20, flush),
        bytes=sum(t.numel() * t.element_size() for t in (q, k, v, out)),
        ops=f"{4 * d * pairs * B * Hq} FLOP",
        ops_ms=1e3 * 4 * d * pairs * B * Hq / PEAK_BF16_FLOPS,
        replaces="src/repro/kernels/flash_attention.py:98",
        source="src/repro_torch/csrc/flash_attention.cu")

    # decode at a step of the main path: a 512-token prompt in a 1024-slot cache
    B, Hq, Hkv, Tk, d = DECODE_MAIN
    valid = (torch.arange(Tk, device=dev) <= PROMPT_LEN)[None].expand(B, Tk).contiguous()
    (q, k, v, valid), _ = decode_case(DECODE_MAIN, torch.bfloat16, valid)
    out = ops.decode_attention(q, k, v, valid)
    err = check_close(f"decode_attention{DECODE_MAIN}", out,
                      ref.decode_attention_ref(q, k, v, valid), TOL["bfloat16"])
    kq = k.transpose(1, 2).repeat_interleave(Hq // Hkv, 1)
    vq = v.transpose(1, 2).repeat_interleave(Hq // Hkv, 1)
    q4, mask4 = q[:, :, None], valid[:, None, None, :]
    records["decode_attention"] = dict(
        err=err,
        ms=time_ms(torch, lambda: ops.decode_attention(q, k, v, valid), 50, flush),
        plain_ms=time_ms(torch, lambda: ref.decode_attention_ref(q, k, v, valid), 10, flush),
        library_ms=time_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, kq, vq, attn_mask=mask4), 50, flush),
        # K/V of invalid slots cannot change the output: only valid slots count
        bytes=sum(t.numel() * t.element_size() for t in (q, valid, out))
        + 2 * int(valid.sum()) * Hkv * d * k.element_size(),
        ops=f"{4 * d * Hq * int(valid.sum())} FLOP",
        ops_ms=1e3 * 4 * d * Hq * int(valid.sum()) / PEAK_BF16_FLOPS,
        replaces="src/repro/kernels/decode_attention.py:77",
        source="src/repro_torch/csrc/decode_attention.cu")
    def report(name, r):
        t_bytes = 1e3 * r["bytes"] / PEAK_BYTES_PER_S
        r["bound_ms"], r["bound_by"] = max((t_bytes, "bytes"), (r["ops_ms"], "operations"))
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"kernels {name}: ms {r['ms']:.4f}  plain_ms {r['plain_ms']:.4f}  "
              f"library_ms {lib}  bound_ms {r['bound_ms']:.6f} ({r['bound_by']}; "
              f"{r['bytes']} B in {t_bytes:.6f} ms, {r['ops']} in {r['ops_ms']:.6f} ms)  "
              f"max |diff| {r['err']:.3g}")

    for name, r in records.items():
        report(name, r)

    # -- 4 ------------------------------------------------------------------
    phase("4 reduced qwen3-1.7b, card against CPU, float32")
    rng = np.random.default_rng(SEED)
    for kv_heads in (None, 2):
        cfg = reduced(get_arch("qwen3-1.7b"))
        cfg = dataclasses.replace(cfg, dtype="float32",
                                  **({} if kv_heads is None else {"n_kv_heads": kv_heads}))
        p_cpu = T.init_params(cfg, torch.Generator().manual_seed(SEED))
        p_gpu = tree_to(p_cpu, dev)
        prompts = rng.integers(0, cfg.vocab_size, (4, 24)).tolist()
        toks = torch.tensor(prompts)
        logits = {}
        for where, p in (("cpu", p_cpu), ("cuda", p_gpu)):
            lg, c = T.prefill(p, cfg, {"tokens": toks.to(where)}, seq_len=40)
            lg2, _ = T.decode_step(p, cfg, lg.argmax(-1), 24, c)
            logits[where] = (lg.cpu(), lg2.cpu())
        for i, step in enumerate(("prefill", "decode")):
            e = check_close(f"{cfg.name} kv={cfg.n_kv_heads} {step} logits",
                            logits["cuda"][i], logits["cpu"][i], (1e-4, 1e-4))
            print(f"  kv_heads {cfg.n_kv_heads}: {step} logits max |diff| {e:.3g}")
        outs = [ServingEngine(cfg, batch_slots=4, max_seq_len=40, device=where,
                              params=p).generate(prompts, max_new_tokens=8)
                for where, p in (("cpu", p_cpu), ("cuda", p_gpu))]
        if outs[0] != outs[1]:
            raise AssertionError(f"greedy tokens differ: cpu {outs[0]} cuda {outs[1]}")
        print(f"  kv_heads {cfg.n_kv_heads}: greedy tokens equal ({outs[1][0]} ...)")

    # -- 5 ------------------------------------------------------------------
    phase("5 full-width qwen3-1.7b served on the card")
    cfg = get_arch("qwen3-1.7b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, batch_slots=SLOTS, max_seq_len=MAX_SEQ, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.dtype}; "
          f"weights drawn in {time.perf_counter() - t0:.1f} s")
    prompts = rng.integers(0, cfg.vocab_size, (SLOTS, PROMPT_LEN)).tolist()
    eng.generate(prompts, max_new_tokens=2)          # warm-up: cuBLAS, libraries
    eng.step_times_s.clear()
    ops.reset_launches()
    outs = eng.generate(prompts, max_new_tokens=NEW_TOKENS)
    launches = dict(ops.LAUNCHES)
    n_decode = len(eng.step_times_s) - 1
    expect = {"flash_attention": cfg.n_layers, "decode_attention": cfg.n_layers * n_decode,
              "aes_ctr": 0}
    print(f"launches {launches} over 1 prefill and {n_decode} decode steps")
    if launches != expect:
        raise AssertionError(f"launch counts {launches}, expected {expect}")
    if [len(o) for o in outs] != [NEW_TOKENS] * SLOTS or \
            not all(0 <= t < cfg.vocab_size for o in outs for t in o):
        raise AssertionError("generated tokens out of shape or range")
    with torch.inference_mode():
        lg, _ = T.prefill(eng.params, cfg, {"tokens": torch.tensor(prompts, device=dev)[:1]},
                          seq_len=MAX_SEQ)
    if not bool(lg.float().isfinite().all()):
        raise AssertionError("full-width logits are not finite")
    prefill_ms = 1e3 * eng.step_times_s[0]
    total_s = sum(eng.step_times_s)
    step_us = eng.mean_decode_step_us()
    print(f"serve prefill_ms {prefill_ms:.3f}  mean_decode_step_us {step_us:.1f}  "
          f"generated_tok_per_s {SLOTS * NEW_TOKENS / total_s:.1f}  "
          f"max_memory_allocated_bytes {torch.cuda.max_memory_allocated()}")
    print(f"  first request's tokens: {outs[0][:8]} ...")
    device_us, wall_us, top = profile_decode(torch, T, eng, cfg, prompts, dev)
    if device_us is None:
        print(f"decode step device time: not measured (the profiler saw no kernel); "
              f"wall_us {wall_us:.1f}")
    else:
        print(f"decode step over {PROFILED_STEPS} profiled steps: device_us {device_us:.1f}  "
              f"wall_us {wall_us:.1f}  device idle share {1 - device_us / wall_us:.3f}")
        for name, us in top:
            print(f"  {us:10.1f} us/step  {name[:100]}")

    # -- 6 ------------------------------------------------------------------
    phase("6 AES-128-CTR kernel against its plain version, bit-exact")
    key_hex, pt_hex, ct_hex = FIPS197_C1

    def hex_bytes(h, device):
        return torch.tensor(list(bytes.fromhex(h)), dtype=torch.int32, device=device)

    fips_key, fips_pt = hex_bytes(key_hex, dev), hex_bytes(pt_hex, dev)
    got = bytes(ref.aes_encrypt_block_ref(fips_pt, ref.aes_key_expand(fips_key)).tolist()).hex()
    if got != ct_hex:
        raise AssertionError(f"FIPS-197 C.1: plain AES gives {got}, expected {ct_hex}")
    print(f"  FIPS-197 C.1 through the plain block cipher: {got}")
    keys = {"fips": fips_key,
            "random": torch.tensor(rng.integers(0, 256, 16), dtype=torch.int32, device=dev)}
    calls_before, calls = ops.LAUNCHES["aes_ctr"], 0

    def rand_int32(n):
        return torch.randint(-2**31, 2**31, (n, 16), generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32)

    # the kernel's counter-mode output against the plain keystream of the C.1 key
    pt = fips_pt.repeat(AES_FN_BLOCKS, 1)
    ct = ops.aes_ctr(pt, fips_key, nonce=0)
    calls += 1
    if not torch.equal(ct ^ pt, ref.aes_ctr_keystream(AES_FN_BLOCKS, ref.aes_key_expand(fips_key))):
        raise AssertionError("aes_ctr: ct ^ pt is not the plain keystream under the C.1 key")
    aes_err = 0
    for kname, key in keys.items():
        for n in AES_SWEEP_N:
            for nonce in AES_NONCES:
                pt = rand_int32(n)
                out = ops.aes_ctr(pt, key, nonce=nonce)
                calls += 1
                plain = ref.aes_ctr_ref(pt, key, nonce)
                torch.cuda.synchronize()
                err = int((out.long() - plain.long()).abs().max())
                if not torch.equal(out, plain):
                    raise AssertionError(f"aes_ctr key {kname} N {n} nonce {nonce}: "
                                         f"max |diff| {err}, expected bit-exact")
                aes_err = max(aes_err, err)
        print(f"  key {kname}: N {AES_SWEEP_N} x nonces {AES_NONCES} bit-exact")
    pt = rand_int32(AES_FN_BLOCKS)
    back = ops.aes_ctr(ops.aes_ctr(pt, keys["random"], nonce=5), keys["random"], nonce=5)
    calls += 2
    if not torch.equal(back, pt):
        raise AssertionError("aes_ctr: the round trip does not decrypt")
    if ops.aes_ctr(rand_int32(0), keys["random"]).shape != (0, 16):
        raise AssertionError("aes_ctr: N = 0 does not give an empty (0, 16) result")
    if ops.LAUNCHES["aes_ctr"] - calls_before != calls:
        raise AssertionError(f"aes_ctr launches {ops.LAUNCHES['aes_ctr'] - calls_before}, "
                             f"expected {calls}")
    print(f"  round trip decrypts; N = 0 launches nothing; {calls} launches counted")

    rk = ref.aes_key_expand(keys["random"])
    sms = props.multi_processor_count
    aes_times = {}
    for n in (AES_FN_BLOCKS, AES_BATCH_BLOCKS):
        pt = rand_int32(n)
        aes_times[n] = dict(
            err=aes_err,
            ms=time_ms(torch, lambda: aes_kernel(pt, rk, nonce=7), 50, flush),
            plain_ms=time_ms(torch, lambda: pt ^ ref.aes_ctr_keystream(n, rk, 7), 10, flush),
            library_ms=None,            # no PyTorch call computes AES
            bytes=2 * pt.numel() * pt.element_size() + rk.numel() * rk.element_size(),
            ops=f"{AES_LOOKUPS_PER_BLOCK * n} S-box lookups",
            ops_ms=1e3 * AES_LOOKUPS_PER_BLOCK * n / (SMEM_LOOKUPS_PER_CLOCK * sms * sm_clock_hz),
            replaces="src/repro/kernels/aes_ctr.py:76",
            source="src/repro_torch/csrc/aes_ctr.cu")
        report(f"aes_ctr N={n}", aes_times[n])
    records["aes_ctr"] = aes_times[AES_FN_BLOCKS]

    # -- 7 ------------------------------------------------------------------
    phase("7 FaaS path: both functions deployed on containerd and junctiond (simulated)")
    payload = torch.tensor(rng.integers(0, 256, (AES_FN_BLOCKS, 16)), dtype=torch.int32)
    fn_key = keys["random"].cpu()
    ops.reset_launches()
    body_us = []
    for _ in range(BODY_CALLS):
        t0 = time.perf_counter()
        ct = ops.aes_ctr(payload.to(dev), fn_key, nonce=0).cpu()
        torch.cuda.synchronize()
        body_us.append(1e6 * (time.perf_counter() - t0))
    if not torch.equal(ct, ref.aes_ctr_ref(payload, fn_key, 0)):
        raise AssertionError("the AES function's reply differs from the plain version on the CPU")
    aes_us = float(np.median(body_us))
    print(f"AES function body (600 B to the card, kernel, back, synchronised), "
          f"median of {BODY_CALLS} calls on {props.name}: work_us {aes_us:.1f}")

    def host_us(fn):
        """Median host time of ``fn`` and a synchronise, over BODY_CALLS calls."""
        ts = []
        for _ in range(BODY_CALLS):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(1e6 * (time.perf_counter() - t0))
        return float(np.median(ts))

    ct_dev = ct.to(dev)
    print(f"  parts of the body, each alone: key schedule to the card "
          f"{host_us(lambda: ref.aes_key_expand(fn_key).to(dev)):.1f} us, payload to the card "
          f"{host_us(lambda: payload.to(dev)):.1f} us, reply to the host "
          f"{host_us(lambda: ct_dev.cpu()):.1f} us; kernel alone (phase 6, CUDA events) "
          f"{1e3 * records['aes_ctr']['ms']:.1f} us")
    functions = {
        "aes": (FunctionSpec(name="aes", work_us=aes_us), AES_REQUESTS),
        cfg.name: (FunctionSpec(name=cfg.name, work_us=step_us, payload_bytes=2048,
                                response_bytes=4096), MODEL_REQUESTS),
    }
    for fname, (spec, n_req) in functions.items():
        medians = {}
        for backend in ("containerd", "junctiond"):
            rt = FaasdRuntime(Simulator(seed=1), backend=backend)
            rt.deploy_blocking(spec)
            s = run_sequential(rt, fname, n=n_req)
            if s.n != n_req:
                raise AssertionError(f"{fname} on {backend}: {s.n} latencies for {n_req} requests")
            medians[backend] = s
            print(f"  {fname} (work_us {spec.work_us:.1f} measured) on {backend:10s}: "
                  f"simulated median_ms {s.median_ms:.4f}  p99_ms {s.p99_ms:.4f}  n {s.n}")
        c, j = medians["containerd"], medians["junctiond"]
        if not j.median_ms < c.median_ms:
            raise AssertionError(f"{fname}: junctiond median {j.median_ms} is not below "
                                 f"containerd's {c.median_ms}")
        print(f"  {fname}: junctiond cuts the simulated median by "
              f"{100 * (1 - j.median_ms / c.median_ms):.2f} % and the p99 by "
              f"{100 * (1 - j.p99_ms / c.p99_ms):.2f} %")
    faas_launches = dict(ops.LAUNCHES)
    print(f"launches {faas_launches} on the FaaS path")
    if faas_launches != {"flash_attention": 0, "decode_attention": 0, "aes_ctr": BODY_CALLS}:
        raise AssertionError(f"FaaS path launches {faas_launches}, expected "
                             f"{BODY_CALLS} of aes_ctr only")
    launches["aes_ctr"] = faas_launches["aes_ctr"]

    # -- result -------------------------------------------------------------
    print(smi)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": r["source"], "replaces": r["replaces"],
         "launches": launches[name], "max_abs_err": r["err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]}
        for name, r in records.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
