"""correction_roofline: in the traced run's counting pass, the least
time of its correction work on the violating sets
(``bench/costs/model.py::correction_cost_v``) over the device time of the
kernels named ``correction_*`` in that pass, %."""

from bench.costs import model


def read(run):
    c = getattr(run, "count_pass", None)
    if run.trace is None or c is None or not c.launches["correction"]:
        return None
    kernel_s = sum(s for name, s in run.trace["pass_by_name"].items()
                   if "correction_" in name)
    if kernel_s <= 0:
        return None
    need = model.bound_s(*model.correction_cost_v(
        run.q * run.n, run.D, run.d, c.viol,
        calls=c.launches["correction"]))
    return 100.0 * need / kernel_s
