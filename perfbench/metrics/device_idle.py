"""Share of the traced window in which no device activity ran, %."""
from perfbench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
