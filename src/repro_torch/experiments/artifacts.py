"""Machine-readable bench artifacts (``BENCH_<suite>.json``).

One artifact per suite run: every scenario's per-backend curves, latency
histograms, knee/SLO metrics, and paper-claim deltas, plus a flat
``metrics`` table (the old CSV rows) so regression tooling can diff runs
without knowing scenario internals.  ``validate_artifact`` is the schema
gate used both before writing and by the tests.

The port's copy of the JAX package's ``experiments/artifacts.py``.
"""
from __future__ import annotations

import json
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

# v2: scenario entries record the configured backend matrix
# (``backend_set``) and the (baseline, treatment) ``claims_pair`` next to
# the per-backend results, so artifact consumers never have to assume the
# containerd/junctiond pair.
# v3: control-plane telemetry — a per-backend result may carry an
# ``autoscaler`` block (scale-event counts, scale-up reaction-time
# percentiles, cold starts, replica timeline); when present it must have
# the keys regression tooling reads.  Older artifacts (v1/v2, the
# trendline baseline case) still validate: version-specific keys are
# required only when the document declares that schema_version.
# v4: adaptive knee search — an open-mode per-backend result may carry a
# ``search`` block (the spec the search ran with, total probe count,
# per-seed knees, converged flag, and the recorded per-seed probe
# traces); grid-mode results carry none.  Either way the representative
# latency row is tracked by index (``knee_row``), never by re-matching
# the knee rate by float equality.
# v5: fleet mode — a per-backend result may carry a ``fleet`` block
# (cluster size, primary placement/distribution, per-variant results
# over the placement x distribution grid, each with a per-worker
# telemetry list: placement counts, latency percentiles, storm pull
# timelines, autoscaler reaction summaries).  When the scenario compares
# tree vs naive distribution the block also carries
# ``tree_provisioning_speedup`` (naive/tree time-to-full-capacity).
# v6: chain mode — a per-backend result with ``mode == "chain"`` must
# carry a ``chain`` block (root counts, root latency percentiles, and
# per-hop-depth rows with the per-hop platform tax) and may carry a
# ``fusion`` block (the fused-run chain block plus the fused-vs-unfused
# ``p99_improvement`` and ``pool_efficiency`` ratios).
SCHEMA_VERSION = 6
_SUPPORTED_SCHEMA_VERSIONS = (1, 2, 3, 4, 5, 6)

_REQUIRED_TOP = ("schema_version", "suite", "duration_scale", "scenarios",
                 "metrics", "failures", "meta")
_REQUIRED_SCENARIO_V1 = ("name", "mode", "description", "backends")
_REQUIRED_SCENARIO_V2 = _REQUIRED_SCENARIO_V1 + ("backend_set",)
_REQUIRED_METRIC = ("name", "value", "derived")
_REQUIRED_AUTOSCALER = ("policy", "n_scale_events", "cold_starts",
                        "cold_path_arrivals", "reaction_p50_ms")
_REQUIRED_SEARCH = ("spec", "n_probes", "knee_rps_per_seed", "converged",
                    "trace")
_REQUIRED_FLEET = ("n_workers", "placement", "distribution", "variants")
_REQUIRED_FLEET_VARIANT = ("placement", "distribution", "workers")
_REQUIRED_FLEET_WORKER = ("worker", "n", "placements")
_REQUIRED_CHAIN = ("n_roots", "roots_completed", "root_median_ms",
                   "root_p99_ms", "hop_tax_mean_ms", "hops")
_REQUIRED_CHAIN_HOP = ("hop", "n", "median_ms", "p99_ms", "tax_mean_ms")
_REQUIRED_FUSION = ("chain", "p99_improvement", "pool_efficiency")


def latency_histogram(lat_ms: Sequence[float], n_bins: int = 24) -> Dict[str, list]:
    """Log-spaced latency histogram (µs-to-tail latencies span decades)."""
    lat = np.asarray([l for l in lat_ms if l > 0 and math.isfinite(l)])
    if len(lat) == 0:
        return {"edges_ms": [], "counts": []}
    lo, hi = float(lat.min()), float(lat.max())
    if hi <= lo:
        hi = lo * 1.001 + 1e-9
    edges = np.logspace(np.log10(lo), np.log10(hi), n_bins + 1)
    counts, _ = np.histogram(lat, bins=edges)
    return {"edges_ms": [round(float(e), 6) for e in edges],
            "counts": [int(c) for c in counts]}


def metric_row(name: str, value: float, derived: str) -> Dict[str, object]:
    v = float(value)
    return {"name": name, "value": v if math.isfinite(v) else None,
            "derived": derived}


def build_artifact(suite: str, scenarios: List[Dict[str, object]],
                   metrics: List[Dict[str, object]],
                   failures: List[Dict[str, str]],
                   duration_scale: float = 1.0,
                   meta: Optional[Dict[str, object]] = None) -> Dict[str, object]:
    return {
        "schema_version": SCHEMA_VERSION,
        "suite": suite,
        "duration_scale": duration_scale,
        "scenarios": scenarios,
        "metrics": metrics,
        "failures": failures,
        "meta": meta or {},
    }


def _fleet_problems(fleet: object) -> List[str]:
    """Schema problems inside one per-backend ``fleet`` block (v5)."""
    if not isinstance(fleet, dict):
        return [".fleet must be an object"]
    probs = [f".fleet missing {key!r}"
             for key in _REQUIRED_FLEET if key not in fleet]
    variants = fleet.get("variants")
    if variants is None:
        return probs
    if not isinstance(variants, list):
        return probs + [".fleet.variants must be a list"]
    for j, var in enumerate(variants):
        if not isinstance(var, dict):
            probs.append(f".fleet.variants[{j}] must be an object")
            continue
        probs.extend(f".fleet.variants[{j}] missing {key!r}"
                     for key in _REQUIRED_FLEET_VARIANT if key not in var)
        workers = var.get("workers")
        if workers is None:
            continue
        if not isinstance(workers, list):
            probs.append(f".fleet.variants[{j}].workers must be a list")
            continue
        for k, w in enumerate(workers):
            if not isinstance(w, dict) or any(key not in w
                                              for key in _REQUIRED_FLEET_WORKER):
                probs.append(f".fleet.variants[{j}].workers[{k}] must have "
                             f"keys {_REQUIRED_FLEET_WORKER}")
    return probs


def _chain_problems(res: dict) -> List[str]:
    """Schema problems inside one ``mode == "chain"`` per-backend result
    (v6): the ``chain`` block is required, ``fusion`` optional."""
    probs: List[str] = []
    chain = res.get("chain")
    if not isinstance(chain, dict):
        return [".chain must be an object on chain-mode results"]

    def block(prefix: str, blk: dict) -> None:
        probs.extend(f"{prefix} missing {key!r}"
                     for key in _REQUIRED_CHAIN if key not in blk)
        hops = blk.get("hops")
        if not isinstance(hops, list):
            return
        for j, row in enumerate(hops):
            if not isinstance(row, dict) or any(key not in row
                                                for key in _REQUIRED_CHAIN_HOP):
                probs.append(f"{prefix}.hops[{j}] must have keys "
                             f"{_REQUIRED_CHAIN_HOP}")

    block(".chain", chain)
    fusion = res.get("fusion")
    if fusion is not None:
        if not isinstance(fusion, dict):
            probs.append(".fusion must be an object")
        else:
            probs.extend(f".fusion missing {key!r}"
                         for key in _REQUIRED_FUSION if key not in fusion)
            if isinstance(fusion.get("chain"), dict):
                block(".fusion.chain", fusion["chain"])
            elif "chain" in fusion:
                probs.append(".fusion.chain must be an object")
    return probs


def validate_artifact(doc: Dict[str, object]) -> None:
    """Raise ValueError describing every schema violation found."""
    problems: List[str] = []
    if not isinstance(doc, dict):
        raise ValueError("artifact must be a JSON object")
    for key in _REQUIRED_TOP:
        if key not in doc:
            problems.append(f"missing top-level key {key!r}")
    version = doc.get("schema_version")
    if version not in _SUPPORTED_SCHEMA_VERSIONS:
        problems.append(f"schema_version must be one of "
                        f"{_SUPPORTED_SCHEMA_VERSIONS}, got {version!r}")
    required_scenario = (_REQUIRED_SCENARIO_V1 if version == 1
                         else _REQUIRED_SCENARIO_V2)
    if not isinstance(doc.get("scenarios"), list):
        problems.append("scenarios must be a list")
    else:
        for i, sc in enumerate(doc["scenarios"]):
            if not isinstance(sc, dict):
                problems.append(f"scenarios[{i}] must be an object")
                continue
            for key in required_scenario:
                if key not in sc:
                    problems.append(f"scenarios[{i}] ({sc.get('name', '?')}) "
                                    f"missing {key!r}")
            backends = sc.get("backends")
            if isinstance(backends, dict):
                for b, res in backends.items():
                    if not isinstance(res, dict):
                        problems.append(f"scenarios[{i}].backends[{b}] "
                                        "must be an object")
                        continue
                    asc = res.get("autoscaler")
                    if version in (3, 4, 5, 6) and asc is not None:
                        if not isinstance(asc, dict):
                            problems.append(f"scenarios[{i}].backends[{b}]"
                                            ".autoscaler must be an object")
                        else:
                            for key in _REQUIRED_AUTOSCALER:
                                if key not in asc:
                                    problems.append(
                                        f"scenarios[{i}].backends[{b}]"
                                        f".autoscaler missing {key!r}")
                    search = res.get("search")
                    if version in (4, 5, 6) and search is not None:
                        if not isinstance(search, dict):
                            problems.append(f"scenarios[{i}].backends[{b}]"
                                            ".search must be an object")
                        else:
                            for key in _REQUIRED_SEARCH:
                                if key not in search:
                                    problems.append(
                                        f"scenarios[{i}].backends[{b}]"
                                        f".search missing {key!r}")
                    fleet = res.get("fleet")
                    if version in (5, 6) and fleet is not None:
                        problems.extend(
                            f"scenarios[{i}].backends[{b}]{p}"
                            for p in _fleet_problems(fleet))
                    if version == 6 and res.get("mode") == "chain":
                        problems.extend(
                            f"scenarios[{i}].backends[{b}]{p}"
                            for p in _chain_problems(res))
            else:
                problems.append(f"scenarios[{i}].backends must be an object")
            backend_set = sc.get("backend_set")
            if backend_set is not None and not (
                    isinstance(backend_set, list)
                    and all(isinstance(b, str) for b in backend_set)):
                problems.append(f"scenarios[{i}].backend_set must be a "
                                "list of backend names")
    if not isinstance(doc.get("metrics"), list):
        problems.append("metrics must be a list")
    else:
        for i, row in enumerate(doc["metrics"]):
            if not isinstance(row, dict) or any(k not in row
                                                for k in _REQUIRED_METRIC):
                problems.append(f"metrics[{i}] must have keys "
                                f"{_REQUIRED_METRIC}")
    if not isinstance(doc.get("failures"), list):
        problems.append("failures must be a list")
    if problems:
        raise ValueError("invalid bench artifact: " + "; ".join(problems))


def write_artifact(path: str, doc: Dict[str, object]) -> None:
    validate_artifact(doc)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=False)
        f.write("\n")


def metrics_csv(doc: Dict[str, object]) -> str:
    """The legacy ``name,us_per_call,derived`` view of an artifact."""
    lines = ["name,value,derived"]
    for row in doc.get("metrics", []):
        v = row["value"]
        v_str = f"{v:.3f}" if isinstance(v, (int, float)) else "nan"
        lines.append(f"{row['name']},{v_str},{row['derived']}")
    return "\n".join(lines)
