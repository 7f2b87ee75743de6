"""idle_share: 1 - the union of device-operation intervals over the
traced window's wall (the harness's own copies at the checked ticks left
out of both; the window carries no counting), %."""


def read(run):
    t = run.trace
    if t is None:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
