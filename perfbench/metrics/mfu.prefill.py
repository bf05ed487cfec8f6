"""The prefill's share of the roofline: its needed work
(``counts.prefill_step``) over its device time, %."""
from perfbench.readers import step_mfu
from perfbench.work import counts


def read(ctx):
    return step_mfu(ctx, "prefill", lambda cfg, s: counts.prefill_step(cfg, s["batch"], s["seq"]))
