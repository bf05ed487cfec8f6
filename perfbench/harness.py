"""One run of one cell of ``BENCHMARK.json``: set-up, the measured window,
the check of what the window produced, and the result line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file the harness finds by name: the cell's entry in
``BENCHMARK.json`` names its configuration (``configs/<config>.json``,
whose ``reference`` names the plain reference under ``reference/``) and
its mix (``traffic/<traffic>.json``, whose ``kind`` picks the runner);
``limits/<workload>.json`` holds the limits of its checks; each per-layer
metric is ``metrics/<name>.py``, a ``read(ctx)`` that returns a number or
None (nothing to read: the metric is left out of the line).

The program under test is ``repro_torch`` (under ``src/``): a served mix
drives ``ServingEngine.generate`` in a closed loop on graphs captured in
set-up, its window closing at the end of the first whole block of the
mix's prompt lengths (``traffic.Serve``) that ends at or after
``--seconds``; a training mix the step of ``make_train_step`` captured by
``TrainGraph`` and replayed, its window closing at the synchronize after
the last step dispatched before ``--seconds``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from perfbench import traffic as traffic_mod
from perfbench import weights
from perfbench.readers import p95
from perfbench.trace import Trace, busy_ns, labelled_gaps, top_ops
from perfbench.work import counts

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Refused(Exception):
    """The run cannot give a result (no card, a missing file, a module
    that must not be loaded)."""


# ---------------------------------------------------------------------------
# finding a cell's files


@dataclasses.dataclass
class Cell:
    name: str
    cfg: dict
    mix: dict
    limits: dict
    per_layer: List[dict]
    end_to_end: List[dict]
    bench_dir: Path


def _load(path: Path) -> dict:
    if not path.is_file():
        raise Refused(f"missing {path}")
    return json.loads(path.read_text())


def find_cell(workload: str, root: Path, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` and its files."""
    bench = _load(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json")

    def mine(metric):
        return "workloads" not in metric or workload in metric["workloads"]

    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(workload, _load(root / cfg_entry["file"]),
                _load(bench_dir / "traffic" / f"{entry['traffic']}.json"),
                _load(bench_dir / "limits" / f"{workload}.json"),
                [m for m in bench["per_layer"] if mine(m)],
                [m for m in bench["end_to_end"] if mine(m)], bench_dir)


def program_arch(cfg: dict):
    """The port's ``ArchConfig`` that the configuration file names, cut as
    the file says; raises where a published key the file holds disagrees
    with what the port would run."""
    import dataclasses as dc

    from repro_torch.config import get_arch
    prog = cfg["program"]
    arch = get_arch(prog["arch"])
    over = {k: v for k, v in prog.items() if k != "arch"}
    for k, v in over.items():
        if isinstance(v, dict):          # a nested group, such as ``moe``
            over[k] = dc.replace(getattr(arch, k), **v)
    arch = dc.replace(arch, **over)
    m = counts.dims(cfg)
    pairs = {"hidden_size": (m["d"], arch.d_model), "intermediate_size": (m["f"], arch.d_ff),
             "num_attention_heads": (m["h"], arch.n_heads),
             "num_key_value_heads": (m["kv"], arch.n_kv_heads),
             "head_dim": (m["hd"], arch.resolved_head_dim), "vocab_size": (m["v"], arch.vocab_size),
             "num_hidden_layers": (m["L"], arch.n_layers),
             "rope_theta": (cfg["rope_theta"], arch.rope_theta),
             "rms_norm_eps": (cfg["rms_norm_eps"], arch.norm_eps),
             "tie_word_embeddings": (bool(cfg.get("tie_word_embeddings")), arch.tie_embeddings),
             "torch_dtype": (cfg["torch_dtype"], arch.dtype)}
    if m["E"]:
        pairs.update({"num_local_experts": (m["E"], arch.moe.num_experts),
                      "num_experts_per_tok": (m["k"], arch.moe.top_k),
                      "moe_capacity_factor": (cfg["moe_capacity_factor"],
                                              arch.moe.capacity_factor)})
    horizon = cfg.get("max_position_embeddings", 1 << 30)
    win = cfg.get("sliding_window")
    pairs["sliding_window"] = (None if win is None or win >= horizon else win,
                               arch.sliding_window)
    bad = {k: v for k, v in pairs.items() if v[0] != v[1]}
    if bad:
        raise Refused(f"{cfg['name']}: file and program differ (file, program): {bad}")
    return arch


def metric_reader(cell: Cell, name: str) -> Callable[[dict], Optional[float]]:
    """``metrics/<name>.py``, or where there is none the reader that the
    quantity's cells share, ``metrics/<name up to its first dot>.py``
    (``device_idle.py`` reads ``device_idle.chat`` and ``device_idle.rag``)."""
    path = cell.bench_dir / "metrics" / f"{name}.py"
    if not path.is_file():
        path = cell.bench_dir / "metrics" / f"{name.split('.')[0]}.py"
    if not path.is_file():
        raise Refused(f"no reader for the metric {name} under {path.parent}")
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reference(cfg: dict):
    return importlib.import_module(f"perfbench.reference.{cfg['reference']}")


# ---------------------------------------------------------------------------
# helpers


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def log(msg: str) -> None:
    print(f"[perfbench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# serving


def run_serve(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
              control: bool = False) -> dict:
    from repro_torch.serving.engine import ServingEngine

    cfg, mix = cell.cfg, cell.mix
    arch = program_arch(cfg)
    gen = traffic_mod.Serve(mix, seed, cfg["vocab_size"])
    n_new = mix["new_tokens"]
    params = weights.make(cfg, seed, device)
    eng = ServingEngine(arch, batch_slots=gen.batch, max_seq_len=max(gen.lengths) + n_new + 1,
                        seed=seed, device=device, params=params)
    # set-up: capture each prompt shape's prefill and the decode step, then one
    # short invocation a shape through generate, so the window builds nothing
    for length in gen.lengths:
        prompts = gen.warm_prompts(length)
        toks = torch.tensor(prompts, dtype=torch.long, device=device)
        eng.capture({"tokens": toks}, toks[:, -1:], length)
        eng.generate(prompts, max_new_tokens=min(2, n_new), temperature=0.0)
    sync(device)
    capture_s = sum(eng.capture_s)
    n_traced = mix["trace_invocations"] if trace else 0
    prof = _profiler() if trace else None
    runs = []          # (index, prompt length, wall s, its step times, served tokens)
    t_open = time.perf_counter()
    setup_s = t_open - t_start
    if prof is not None:
        prof.start()
    i = 0
    while True:
        prompts = gen.prompts(i)
        k0 = len(eng.step_times_s)
        span = (torch.profiler.record_function("bench.invocation") if i < n_traced
                else contextlib.nullcontext())
        with span:
            t0 = time.perf_counter()
            out = eng.generate(prompts, max_new_tokens=n_new, temperature=0.0)
            t1 = time.perf_counter()
        runs.append((i, len(prompts[0]), t1 - t0, eng.step_times_s[k0:], out))
        t_close = t1
        i += 1
        if prof is not None and i == n_traced:
            prof.stop()
        # the window closes after whole blocks of the mix's lengths, so that
        # every seed does the same work
        if t1 - t_open >= seconds and i % len(gen.lengths) == 0:
            break
    window_s = t_close - t_open
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    del eng
    free(device)

    attempted = len(runs) * gen.batch
    failed = sum(1 for r in runs for row in r[4] if len(row) != n_new)
    tokens = sum(len(row) for r in runs for row in r[4])
    metrics = {"invocation_ms_p95": p95([1e3 * r[2] for r in runs for _ in range(gen.batch)]),
               "output_tokens_per_s": tokens / window_s, "setup_s": setup_s}
    log(f"set-up {setup_s:.1f} s (captures {capture_s:.1f} s), window {window_s:.1f} s, "
        f"{len(runs)} invocations, peak {peak / 1e9:.2f} GB")
    n = len(gen.lengths)
    blocks = [runs[a:a + n] for a in range(n_traced + (-n_traced) % n, len(runs), n)]
    log("untraced blocks, tokens/s: " + json.dumps(
        [sum(len(row) for r in b for row in r[4]) / sum(r[2] for r in b) for b in blocks]))
    ctx = None
    if trace:
        t = time.perf_counter()
        ctx = _serve_ctx(cell, prof, runs, n_traced, capture_s, gen)
        log(f"trace read in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    checks = _serve_checks(cell, params, gen, runs, seed, device, control)
    log(f"checks in {time.perf_counter() - t:.1f} s")
    return {"attempted": attempted, "failed": failed, "e2e": metrics, "ctx": ctx,
            "checks": checks, "peak": peak}


def _profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _serve_ctx(cell: Cell, prof, runs, n_traced: int, capture_s: float, gen) -> dict:
    tr = Trace.from_profiler(prof)
    names, shapes = [], []
    for idx, length, _, times, out in runs[:n_traced]:
        names.append("prefill")
        shapes.append({"batch": gen.batch, "seq": length})
        for j in range(1, len(times)):
            names.append("decode")
            shapes.append({"batch": gen.batch, "pos": length + j - 1})
    steps = [(n, acts, s) for (n, acts), s in zip(tr.steps(names), shapes)]
    lo, hi = tr.window("bench.invocation")
    return {"kind": "serve", "cfg": cell.cfg, "mix": cell.mix, "trace": tr, "steps": steps,
            "window": (lo, hi), "busy_s": busy_ns(tr.device, lo, hi) / 1e9,
            "window_s": (hi - lo) / 1e9, "capture_s": capture_s,
            "runs": [(length, wall, times) for _, length, wall, times, _ in runs[n_traced:]]}


def check_sample(runs, n: int, seed: int) -> List[int]:
    """The invocations to check, drawn from the seed: the first with the
    longest prompt, one of each other prompt length (each length has its
    own captured prefill), then others up to ``n`` in all."""
    rng = traffic_mod._rng(seed, 4)
    by_len: Dict[int, List[int]] = {}
    for r in runs:
        by_len.setdefault(r[1], []).append(r[0])
    lengths = sorted(by_len, reverse=True)
    pick = [by_len[lengths[0]][0]] + [int(rng.choice(by_len[k])) for k in lengths[1:]]
    rest = [r[0] for r in runs if r[0] not in pick]
    return pick + [int(x) for x in rng.permutation(rest)[:max(0, n - len(pick))]]


def _serve_checks(cell: Cell, params, gen, runs, seed: int, device, control: bool) -> dict:
    """Logit gaps of the served tokens against the reference, over the
    invocations of ``check_sample``: the widest (``max_logit_gap``) and the
    mean (``mean_logit_gap``).  With ``control``, the same of the control
    (``fp8.*``: the fp8 reference's first tokens at the same positions),
    with the share of positions whose token is not the reference's first."""
    ref = reference(cell.cfg)
    pick = check_sample(runs, gen.mix["check_invocations"], seed)
    others = ("fp8",) if control else ()
    got: Dict[str, list] = {}
    for idx in pick:
        prompts = torch.tensor(gen.prompts(idx), dtype=torch.long, device=device)
        served = torch.tensor(runs[idx][4], dtype=torch.long, device=device)
        for k, v in ref.served_gaps(params, cell.cfg, prompts, served, others).items():
            got.setdefault(k, []).append(v.flatten().cpu())
        free(device)
    out = {}
    for k, parts in got.items():
        g = torch.cat(parts)
        pre = "" if k == "gap" else k.replace("_gap", ".")
        out[f"{pre}max_logit_gap"] = float(g.max())
        out[f"{pre}mean_logit_gap"] = float(g.mean())
        if control:
            out[f"{pre}share_not_first"] = float((g > 0).float().mean())
    return out


# ---------------------------------------------------------------------------
# training


def run_train(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
              control: bool = False) -> dict:
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.step_graph import TrainGraph
    from repro_torch.train.train_loop import make_train_step

    cfg, mix = cell.cfg, cell.mix
    arch = program_arch(cfg)
    gen = traffic_mod.Train(mix, seed, cfg["vocab_size"])
    opt = optimizer_config(cfg, mix)
    params = weights.make(cfg, seed, device)
    for p in weights.leaves(params):
        p.requires_grad_(True)
    state = init_state(params)
    step = make_train_step(arch, AdamWConfig(**opt), remat=True)
    first = [gen.batch(i, device) for i in range(mix["first_steps"])]
    on_card = torch.device(device).type == "cuda"
    # the first steps, through the window's own call: step 1 is the graph's
    # warm-up (or the eager step off the card), the rest replays
    losses, grad_norms, change = [], None, None
    graph = None
    for i, batch in enumerate(first):
        if not on_card:
            _, _, m = step(params, state, batch)
        elif graph is None:
            graph = TrainGraph(step, params, state, batch)
            m = graph.first_metrics
        else:
            m = graph.replay(batch)
        losses.append(float(m["loss"]))
        if i == 0:
            b1c = 1 - opt["b1"]
            grad_norms = [float(t.norm()) / b1c for t in weights.leaves(state.mu)]
    change = _change_norms(cfg, params, seed, device)
    sync(device)
    capture_s = graph.capture_s if graph is not None else 0.0
    n_traced = mix["trace_steps"] if trace else 0
    prof = _profiler() if trace else None

    def one(i):
        b = gen.batch(mix["first_steps"] + i, device)
        if graph is None:
            step(params, state, b)
        else:
            graph.replay(b)

    t_open = time.perf_counter()
    setup_s = t_open - t_start
    if prof is not None:
        prof.start()
        with torch.profiler.record_function("bench.steps"):
            for i in range(n_traced):
                one(i)
            sync(device)
        prof.stop()
    done = n_traced
    events = []
    while time.perf_counter() - t_open < seconds:
        if len(events) >= 2:
            events[-2].synchronize()       # at most two steps ahead of the card
        one(done)
        done += 1
        if on_card:
            ev = torch.cuda.Event()
            ev.record()
            events.append(ev)
    sync(device)
    window_s = time.perf_counter() - t_open
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    del graph, state, step, params, events, m
    free(device)
    tokens = done * mix["batch"] * mix["seq_len"]
    metrics = {"train_tokens_per_s": tokens / window_s, "setup_s": setup_s}
    log(f"set-up {setup_s:.1f} s (capture {capture_s:.1f} s), window {window_s:.1f} s, "
        f"{done} steps, peak {peak / 1e9:.2f} GB, losses {losses}")
    ctx = None
    if trace:
        tr = Trace.from_profiler(prof)
        lo, hi = tr.window("bench.steps")
        steps = [(n, acts, {"batch": mix["batch"], "seq": mix["seq_len"]})
                 for n, acts in tr.steps(["train"] * n_traced)]
        ctx = {"kind": "train", "cfg": cfg, "mix": mix, "trace": tr, "steps": steps,
               "window": (lo, hi), "busy_s": busy_ns(tr.device, lo, hi) / 1e9,
               "window_s": (hi - lo) / 1e9, "capture_s": capture_s, "runs": []}
    t = time.perf_counter()
    checks = train_checks(cfg, seed, first, opt, losses, grad_norms, change, device, control)
    log(f"checks in {time.perf_counter() - t:.1f} s")
    return {"attempted": done + mix["first_steps"], "failed": 0, "e2e": metrics, "ctx": ctx,
            "checks": checks, "peak": peak}


def optimizer_config(cfg: dict, mix: dict) -> dict:
    """AdamW's settings for the mix: the rate ``lr`` x ``lr_d_model`` /
    d_model, the warm-up of ``warmup_steps``, the rest at the port's defaults
    (``repro_torch.train.optimizer.AdamWConfig``), written out here."""
    return {"lr": mix["lr"] * mix["lr_d_model"] / cfg["hidden_size"], "b1": 0.9, "b2": 0.95,
            "eps": 1e-8, "weight_decay": 0.1, "grad_clip": 1.0,
            "warmup_steps": mix["warmup_steps"], "total_steps": 10_000, "min_lr_ratio": 0.1}


def _change_norms(cfg: dict, params, seed: int, device) -> List[float]:
    """Per leaf, the norm of the parameters' change since the seed's draw
    (drawn again leaf by leaf, so that no copy of the first weights is
    kept)."""
    start = weights.make(cfg, seed, device)
    out = [float((p.detach().float() - q.float()).norm())
           for p, q in zip(weights.leaves(params), weights.leaves(start))]
    del start
    free(device)
    return out


def train_checks(cfg: dict, seed: int, batches, opt: dict, losses, grad_norms, change,
                 device, control: bool = False) -> dict:
    """The first steps' losses, the first gradient's norm and the
    parameters' change after them, each against the reference, by the
    worst leaf (see ``perfbench.reference.decoder.train_steps``).  With
    ``control``, also the same numbers of the fp8 reference
    (``control.*``) and of the reference that leaves half of each row's
    tokens out of the mean (``half_batch.*``)."""
    ref = reference(cfg)

    def initial():
        return weights.make(cfg, seed, device)
    r = ref.train_steps(initial, cfg, batches, opt)
    free(device)
    out = compare_train(losses, grad_norms, change, r)
    if control:
        seq = batches[0]["tokens"].shape[1]
        for name, kw in (("control", {"quant": "fp8"}), ("half_batch", {"counted": seq // 2})):
            c = ref.train_steps(initial, cfg, batches, opt, **kw)
            free(device)
            got = compare_train(c["losses"], c["grad_norms"], c["change_norms"], r)
            out.update({f"{name}.{k}": v for k, v in got.items()})
    return out


def compare_train(losses, grad_norms, change, r) -> dict:
    gref, cref = r["grad_norms"], r["change_norms"]
    gmed = statistics.median(gref)
    cmed = statistics.median(cref)
    # leaves whose reference gradient is nought to rounding move by round-off
    # alone: left out of the change
    moved = [i for i, g in enumerate(gref) if g >= 1e-3 * gmed]
    return {
        "loss_rel_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, r["losses"])),
        "grad_norm_gap": max(abs(a - b) / max(b, gmed) for a, b in zip(grad_norms, gref)),
        "change_norm_gap": max(abs(change[i] - cref[i]) / max(cref[i], cmed) for i in moved),
    }


# ---------------------------------------------------------------------------
# the run


RUNNERS = {"serve": run_serve, "train": run_train}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             root: Optional[Path] = None, bench_dir: Path = BENCH_DIR,
             t_start: Optional[float] = None, control: bool = False) -> dict:
    """One run of ``workload``: the result line's object, with the checks'
    numbers and limits under ``checks``.  ``control`` adds the control's
    readings (and the planted faults') under ``readings``: not a benchmark
    run."""
    t_start = time.perf_counter() if t_start is None else t_start
    root = bench_dir.parent if root is None else root
    cell = find_cell(workload, root, bench_dir)
    readers = {m["name"]: metric_reader(cell, m["name"]) for m in cell.per_layer} if trace else {}
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    out = RUNNERS[cell.mix["kind"]](cell, seed, seconds, trace, device, t_start, control)
    missing = sorted(set(cell.limits) - set(out["checks"]))
    if missing:
        raise Refused(f"{workload}: the limits name numbers the run did not read: {missing}")
    readings = {k: v for k, v in out["checks"].items() if k not in cell.limits}
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in out["checks"].items()
              if k in cell.limits}
    correct = out["failed"] == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    units = {m["name"]: m["unit"] for m in cell.per_layer + cell.end_to_end}
    if trace:
        metrics = {}
        for name, read in readers.items():
            v = read(out["ctx"])
            if v is not None:
                metrics[name] = {"value": v, "unit": units[name]}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(out["peak"])}
    result = {"correct": bool(correct), "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if trace:
        ctx = out["ctx"]
        dev["busy_s"], dev["window_s"] = ctx["busy_s"], ctx["window_s"]
        lo, hi = ctx["window"]
        result["breakdown"] = {"device_ops": top_ops(_within(ctx["trace"].device, lo, hi)),
                               "idle_gaps": labelled_gaps(ctx["trace"], lo, hi)}
    if control:
        result["readings"] = readings
    result["checks"] = checks
    return result


def _within(acts, lo, hi):
    return [a for a in acts if a.start >= lo and a.end <= hi]


def loaded_forbidden() -> List[str]:
    """The forbidden top-level modules that this process has loaded."""
    names = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(names & set(FORBIDDEN))
