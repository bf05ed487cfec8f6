# Declarative scenario/experiment subsystem: Scenario specs (function mix,
# arrival process, duration, backend matrix) executed by ExperimentRunner
# into machine-readable BENCH_<suite>.json artifacts with per-scenario
# histograms, knee/SLO metrics, and paper-claim deltas.  The port's copy of
# the JAX package's ``experiments/__init__.py``.
from repro_torch.core.workload import ChainEdge, FusionPlan
from repro_torch.experiments.artifacts import (build_artifact, latency_histogram,
                                               metric_row, metrics_csv,
                                               validate_artifact, write_artifact)
from repro_torch.experiments.runner import ExperimentRunner
from repro_torch.experiments.scenario import (DEFAULT_BACKENDS,
                                              DEFAULT_CLAIMS_PAIR, ArrivalSpec,
                                              AutoscalerSpec, FleetSpec,
                                              FunctionProfile, Scenario, SearchSpec,
                                              zipf_mix)
from repro_torch.experiments.suites import (SMOKE_DURATION_SCALE, SUITES,
                                            build_scenarios, get_scenario,
                                            get_suite)

__all__ = [
    "ArrivalSpec", "AutoscalerSpec", "ChainEdge", "FleetSpec",
    "FunctionProfile", "FusionPlan", "Scenario", "SearchSpec", "zipf_mix",
    "DEFAULT_BACKENDS", "DEFAULT_CLAIMS_PAIR",
    "ExperimentRunner",
    "build_artifact", "latency_histogram", "metric_row", "metrics_csv",
    "validate_artifact", "write_artifact",
    "SMOKE_DURATION_SCALE", "SUITES", "build_scenarios", "get_scenario",
    "get_suite",
]
