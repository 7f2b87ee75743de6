"""cycle_mfu: the traced window's share of the card's peak: the least time
of the window's work over the window's wall (the harness's copies at the
checked ticks left out), %.  The work (``lss_state`` on the live slots,
the correction on the violating sets, the deliver of every sent message,
the observe's global decision; ``bench/costs/model.py``) is counted in the
counting pass that follows the window, a tick's worth on average, and
taken for each of the window's ticks."""

from bench.costs import model


def read(run):
    t, c = run.trace, getattr(run, "count_pass", None)
    if t is None or c is None or not c.ticks:
        return None
    rows, n = run.q * run.n, c.launches
    need = (model.bound_s(*model.lss_state_cost(
                rows, run.D, run.d, run.k_max, c.live, calls=n["lss_state"]))
            + model.bound_s(*model.correction_cost_v(
                rows, run.D, run.d, c.viol, calls=n["correction"]))
            + model.bound_s(*model.deliver_cost(
                rows, run.D, run.n, run.d, c.msgs, calls=c.ticks * run.k))
            + model.bound_s(*model.global_cost(
                run.q, run.n, run.d, run.k_max, calls=n["global"]),
                ops_per_s=model.F64_OPS_PER_S))
    return 100.0 * need * run.ticks / c.ticks / t["window_s"]
