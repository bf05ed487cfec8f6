"""A decode step's share of the roofline: its needed work
(``counts.decode_step``: every weight and the valid cache read) over its
device time, %."""
from perfbench.readers import step_mfu
from perfbench.work import counts


def read(ctx):
    return step_mfu(ctx, "decode", lambda cfg, s: counts.decode_step(cfg, s["batch"], s["pos"]))
