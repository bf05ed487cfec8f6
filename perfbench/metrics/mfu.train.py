"""A training step's share of the roofline: its needed work
(``counts.train_step``) over its device time, %."""
from perfbench.readers import step_mfu
from perfbench.work import counts


def read(ctx):
    return step_mfu(ctx, "train", lambda cfg, s: counts.train_step(cfg, s["batch"], s["seq"]))
