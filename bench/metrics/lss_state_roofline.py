"""lss_state_roofline: in the traced run's counting pass, the least time
of its ``lss_state`` work (``bench/costs/model.py::lss_state_cost`` of
each launch's rows and live slots) over the device time of the kernels
named ``lss_state_*`` in that pass, %."""

from bench.costs import model


def read(run):
    c = getattr(run, "count_pass", None)
    if run.trace is None or c is None or not c.launches["lss_state"]:
        return None
    kernel_s = sum(s for name, s in run.trace["pass_by_name"].items()
                   if "lss_state_" in name)
    if kernel_s <= 0:
        return None
    need = model.bound_s(*model.lss_state_cost(
        run.q * run.n, run.D, run.d, run.k_max, c.live,
        calls=c.launches["lss_state"]))
    return 100.0 * need / kernel_s
