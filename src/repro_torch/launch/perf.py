"""Hillclimbing over the dry run's sharding and attention policies.

Runs one (arch x shape) pair under a sequence of policy variants on the
production H100 mesh, records the roofline terms of each, and prints the
hypothesis -> change -> before/after trail:

    PYTHONPATH=src python -m repro_torch.launch.perf --arch deepseek-67b --shape prefill_32k

Counterpart of the JAX package's ``launch/perf.py``, with the same variant
names in the same order; the hypotheses are those of an H100 cluster
(tensor cores, shared memory, NVLink inside a node, the network between
nodes).  The terms are the dry run's predictions from NVIDIA's data-sheet
figures at 700 W.  Records go to ``build/perf/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

from repro_torch.distributed import sharding as sh
from repro_torch.launch.dryrun import RESULTS_DIR, run_pair

PERF_DIR = os.path.join(os.path.dirname(RESULTS_DIR), "perf")


def variants_for(shape_name: str, arch: str) -> List[Tuple[str, sh.Policy, str]]:
    """(variant-name, policy, hypothesis) sequences per shape kind."""
    base = sh.Policy()
    out = [("baseline", base, "the reference's baseline policy")]
    if shape_name in ("train_4k", "prefill_32k"):
        out.append((
            "chunked_attn",
            dataclasses.replace(base, chunked_attention=True),
            "the (S, T) fp32 score matrix of every head dominates HBM traffic; "
            "query chunks of 512 with an online softmax keep a chunk's scores "
            "(the flash kernel keeps them in registers and shared memory) -> "
            "the memory term should drop toward the weight+activation floor"))
        out.append((
            "chunked_attn+ep",
            dataclasses.replace(base, chunked_attention=True,
                                moe_expert_parallel=True),
            "expert weights are tensor-parallel on d_ff; sharding the EXPERT dim "
            "over the node's 8 cards instead turns per-layer weight gathers "
            "into token all-to-alls over NVLink (top2/E of the volume) -> the "
            "collective term drops"))
        out.append((
            "chunked+moe_shard",
            dataclasses.replace(base, chunked_attention=True,
                                shard_moe_dispatch=True),
            "the (E, C, d) MoE dispatch buffer is replicated across the data "
            "axis, so its scatter and gather cross the nodes' network; placing "
            "C over 'data' and d over 'model' keeps the scatter local -> the "
            "collective term should drop by the dispatch share"))
        out.append((
            "chunked+moe_local",
            dataclasses.replace(base, chunked_attention=True,
                                moe_local_dispatch=True),
            "global top-k dispatch needs a cumsum over ALL tokens (rank) and a "
            "combine-gather that both cross data shards, over the network "
            "between nodes; per-shard LOCAL dispatch (the production design) "
            "keeps every MoE tensor's leading dim on the data axis -> those "
            "collectives vanish"))
        out.append((
            "chunked_attn+no_fsdp",
            dataclasses.replace(base, chunked_attention=True, fsdp=False),
            "FSDP gathers the weights over the data axis, between nodes at "
            "50 GB/s a card, every step; replicating them over 'data' trades "
            "HBM capacity (80 GB a card) for that traffic -> expected "
            "REGRESSION in memory, the test quantifies the trade"))
    else:  # decode shapes
        out.append((
            "select_cache_update",
            dataclasses.replace(base, select_cache_update=True),
            "writing the slot of a sequence-sharded KV cache at a position "
            "known only at run time makes DTensor replicate the cache every "
            "step (a gather over NVLink and a full copy); an arange==slot "
            "select is elementwise and keeps the layout -> the memory and "
            "collective terms should fall to the weights plus the cache read"))
        sel = dataclasses.replace(base, select_cache_update=True)
        out.append((
            "sel+mixed_prec",
            dataclasses.replace(sel, attn_mixed_precision=True),
            "the plain decode attention upcasts the bf16 cache to fp32 copies; "
            "bf16 operands with an fp32 accumulator (what the tensor cores and "
            "the decode kernel do) round the softmax weights to bf16 before "
            "their product with v; in the unfused trace the fp32 copies of "
            "the scores' operands stay, so the gain shows only on the card"))
        out.append((
            "sel+replicated_kv_seq",
            dataclasses.replace(sel, seq_sharded_cache=False),
            "a sequence-sharded KV cache makes every decode step reduce "
            "partial attention across 'model' over NVLink; replicating the "
            "cache removes that collective at 8x the cache's HBM -> quantify "
            "the trade (composed on the select fix)"))
        out.append((
            "sel+expert_parallel",
            dataclasses.replace(sel, moe_expert_parallel=True),
            "at B<=128 decode, capacity dispatch computes all E experts; "
            "expert-parallel sharding moves tokens (all-to-all over NVLink) "
            "instead of computing idle experts -> the compute term drops "
            "~E/topk (composed on the select fix)"))
        out.append((
            "sel+no_act_shard",
            dataclasses.replace(sel, act_model_sharded=False),
            "resharding the activations between blocks at B tokens is a "
            "latency-bound collective; replicated activations should cut the "
            "collective term of single-token decode (composed on the select "
            "fix)"))
    return out


def hillclimb(arch: str, shape: str, *, multi_pod: bool = False,
              variants: Optional[List[str]] = None) -> List[Dict]:
    os.makedirs(PERF_DIR, exist_ok=True)
    results = []
    for name, policy, hypothesis in variants_for(shape, arch):
        if variants and name not in variants and name != "baseline":
            continue
        print(f"\n=== {arch} x {shape} :: {name} ===")
        print(f"hypothesis: {hypothesis}")
        try:
            rec = run_pair(arch, shape, multi_pod=multi_pod, probes=True,
                           policy=policy)
        except Exception as e:
            print(f"variant FAILED: {e!r}")
            results.append({"variant": name, "error": repr(e),
                            "hypothesis": hypothesis})
            continue
        rec["variant"] = name
        rec["hypothesis"] = hypothesis
        path = os.path.join(PERF_DIR, f"{arch}__{shape}__{name}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1, default=str)
        results.append(rec)
    _summarise(arch, shape, results)
    return results


def _summarise(arch, shape, results):
    print(f"\n### summary {arch} x {shape} (predicted: H100 SXM data sheet, 700 W)")
    print(f"{'variant':24s} {'compute_ms':>10} {'memory_ms':>10} {'coll_ms':>9} "
          f"{'step_ms':>9} {'bound':>10} {'peakGB':>7}")
    base_step = None
    for r in results:
        roof = r.get("roofline")
        if not roof:
            print(f"{r['variant']:24s}  FAILED: {r.get('error')}")
            continue
        step = roof["step_time_s"] * 1e3
        if r["variant"] == "baseline":
            base_step = step
        gain = f" ({base_step / step:.2f}x)" if base_step and r["variant"] != "baseline" else ""
        print(f"{r['variant']:24s} {roof['compute_s']*1e3:10.2f} "
              f"{roof['memory_s']*1e3:10.2f} {roof['collective_s']*1e3:9.2f} "
              f"{step:9.2f}{gain} {roof['bottleneck']:>10} "
              f"{r['memory'].get('total_gb', float('nan')):7.2f}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", action="append", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    hillclimb(args.arch, args.shape, multi_pod=args.multi_pod,
              variants=args.variant)


if __name__ == "__main__":
    main()
