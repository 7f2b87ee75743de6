"""tenant_cycles_per_s: Q x K x ticks completed in the window over the
window's whole time, first tick's start to the last tick's records on the
host (host clock)."""


def read(run):
    return run.q * run.k * run.ticks / run.window_s
