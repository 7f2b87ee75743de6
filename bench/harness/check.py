"""The comparison that decides ``correct``.

The plain reference (:mod:`bench.reference`) recomputes, from the inputs
the benchmark made, what the monitor answered.  One pass over every tick
of the run replays each tick's feed entries on the reference's side (each
feed module's ``edit``, in the order a boundary applies them: membership,
then updates), which keeps the reference's slot book and the tenants'
inputs, and compares:

* ``region_mismatch``: every tenant's ``region`` in every tick (the warm
  tick, the window and the traced run's counting pass), from the
  benchmark's own copy of the inputs: the alive set and the observe's
  global decision;
* ``record_mismatch`` and ``state_mismatch``: the checked ticks.  The
  warm tick, for a sample of tenants drawn from the seed, from the
  reference's own initial state; ``window_ticks`` ticks of the window,
  spread over it by fractions drawn from the seed, every tenant, from the
  program's state saved just before the tick.  Each goes through the
  tick's feed edits, its K cycles and its observe; a record is wrong when
  its accuracy, quiescence, region or sends differ, a state element when
  it differs from the program's state saved just after the tick;
* each feed's own faults (``membership_mismatch``: a join that did not
  claim the predicted row), and under a dynamic topology the entries of
  the program's slot tables at the end of the run that differ from the
  reference's book, added to ``membership_mismatch``.

Every limit is 0: on the same inputs the monitor's answers are exact, the
reference's arithmetic is the configured one in the same order, and a
control computed a precision lower fails them by thousands.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import lss as ref
from ..reference import topo as ref_topo

LIMITS = {"region_mismatch": 0, "record_mismatch": 0, "state_mismatch": 0,
          "membership_mismatch": 0}
BLOCK_BYTES = 3 << 29  # the replay's state, a block of tenants at a time


def families(tenants, k_max, device, dtype):
    """The tenants' region families as the reference takes them."""
    q, d = len(tenants), tenants[0].x.shape[1]
    kind = torch.zeros(q, dtype=torch.int32)
    centers = torch.zeros((q, k_max, d))
    cmask = torch.zeros((q, k_max), dtype=torch.bool)
    w = torch.zeros((q, d))
    b = torch.zeros(q)
    for i, t in enumerate(tenants):
        if t.kind == "voronoi":
            k = t.centers.shape[0]
            centers[i, :k] = torch.from_numpy(t.centers)
            cmask[i, :k] = True
        else:
            kind[i] = ref.HALFSPACE
            w[i] = torch.from_numpy(t.w)
            b[i] = float(t.b)
    return ref.Families(kind, centers, cmask, w, b).to(device, dtype)


def knobs(tenants, eps, device, dtype):
    return {"beta": torch.tensor([t.beta for t in tenants],
                                 dtype=torch.float32).to(device, dtype),
            "eps": torch.full((len(tenants),), eps,
                              dtype=torch.float32).to(device, dtype),
            "ell": torch.tensor([t.ell for t in tenants], dtype=torch.int32,
                                device=device)}


def _differs(a, b):
    """Elements of ``a`` and ``b`` that are not the same value (two NaNs
    are the same)."""
    a, b = a.to(torch.float64) if a.is_floating_point() else a, \
        b.to(torch.float64) if b.is_floating_point() else b
    bad = a != b
    if a.is_floating_point():
        bad &= ~(torch.isnan(a) & torch.isnan(b))
    return int(bad.sum())


class Plan:
    """Which ticks and tenants the run checks, drawn from the seed: the
    warm tick for ``warm_tenants`` tenants, and ``window_ticks`` ticks of
    the window for every tenant.  Window check j is the first tick that
    starts after the fraction ``at[j]`` of the window, drawn from the j-th
    of ``window_ticks`` equal parts of ``span`` (default [0.05, 0.9))."""

    def __init__(self, rng, q, check: dict):
        n_w = int(check["window_ticks"])
        lo, hi = check.get("span", (0.05, 0.9))
        self.warm = sorted(int(x) for x in rng.choice(
            q, min(q, int(check["warm_tenants"])), replace=False))
        u = rng.random(n_w)
        self.at = [lo + (hi - lo) * (j + u[j]) / n_w for j in range(n_w)]


class Snapshots:
    """Copies, in host memory, of some tenants' state: each taken at a
    tick boundary, the device idle, outside the timed window."""

    def __init__(self, fields):
        self.fields, self.saved, self.who = fields, {}, {}

    def take(self, states, key, slots, who):
        """Save the tenants ``who`` (in the program's ``slots``) under
        ``key``."""
        out = {}
        for f in self.fields:
            src = getattr(states, f)
            dst = torch.empty((len(slots),) + tuple(src.shape[1:]),
                              dtype=src.dtype)
            for j, slot in enumerate(slots):
                dst[j].copy_(src[slot])
            out[f] = dst
        self.saved[key], self.who[key] = out, list(who)

    def block(self, key, rows, device, dtype):
        """Rows ``rows`` of the copy under ``key``, on ``device``, the
        floating fields in ``dtype``."""
        return ref.cast({f: v[rows].to(device) for f, v in
                         self.saved[key].items()}, dtype)

    def tenant_bytes(self, key):
        n = len(self.who[key])
        return sum(v.numel() * v.element_size() for v in
                   self.saved[key].values()) // max(n, 1)


def _tables(book, device):
    return tuple(torch.from_numpy(a.copy()).to(device)
                 for a in (book.nbr, book.mask, book.rev))


def _replay(run, t, edits, tables, fam, knob, device, dtype):
    """``record_mismatch`` and ``state_mismatch`` of checked tick ``t``,
    in blocks of tenants."""
    j = run.checked_ticks[t]
    post = ("post", j)
    who = run.snaps.who[post]
    per = max(1, BLOCK_BYTES // max(1, run.snaps.tenant_bytes(post)))
    recs = run.records[t]
    rec_bad = state_bad = 0
    for lo in range(0, len(who), per):
        rows = list(range(lo, min(lo + per, len(who))))
        ids = [who[r] for r in rows]
        idx = torch.tensor(ids, device=device)
        if t == 0:
            ts = [run.tenants[i] for i in ids]
            x_m = torch.from_numpy(np.stack(
                [x.x * x.weights[:, None] for x in ts])).to(device, dtype)
            x_c = torch.from_numpy(np.stack([x.weights for x in ts])).to(
                device, dtype)
            alive = torch.zeros(x_c.shape, dtype=torch.bool, device=device)
            alive[:, :run.world.n] = True
            st = ref.init_state(x_m, x_c, alive, run.world.D)
        else:
            st = run.snaps.block(("pre", j), rows, device, dtype)
        for e in edits:
            st = e(st)
        st, (acc, quiescent, want, msgs) = ref.tick(
            st, tables, fam.take(idx), {k: v[idx] for k, v in knob.items()},
            run.k)
        got = [a.cpu().numpy() for a in (acc, quiescent, want, msgs)]
        for r, i in enumerate(ids):
            mine = tuple(recs[key][i] for key in ("accuracy", "quiescent",
                                                  "region", "msgs"))
            theirs = (float(got[0][r]), bool(got[1][r]), int(got[2][r]),
                      int(got[3][r]))
            rec_bad += int(mine != theirs)
        saved = run.snaps.block(post, rows, device, torch.float32)
        for f in ref.FIELDS:
            state_bad += _differs(saved[f], st[f])
        del st, saved
    return rec_bad, state_bad


def verdict(numbers, checked, run):
    """``correct``: every number within its limit, no record missing, and
    the warm tick and every planned window tick checked."""
    return (checked == 1 + len(run.plan.at) and run.missing == 0
            and all(numbers[k] <= LIMITS[k] for k in numbers))


def judge(run, device, dtype=torch.float32):
    """Every number compared, the reference computed in ``dtype``.
    Returns ``(numbers, checked ticks)``."""
    fam = families(run.tenants, run.k_max, device, dtype)
    knob = knobs(run.tenants, run.eps, device, dtype)
    w = run.world
    book = ref_topo.SlotBook(w.rows, w.edges, w.n, w.D)
    inputs = {
        "x_m": torch.from_numpy(np.stack([t.x * t.weights[:, None]
                                          for t in run.tenants])).to(
                                              device, dtype),
        "x_c": torch.from_numpy(np.stack([t.weights for t in run.tenants])
                                ).to(device, dtype),
        "alive": torch.from_numpy(book.present.copy()).to(device)[
            None].expand(len(run.tenants), -1).clone()}
    order = sorted(range(len(run.feeds)), key=lambda f: run.feeds[f].STAGE)
    region_bad = rec_bad = state_bad = checked = 0
    for t, recs in enumerate(run.records):
        edits = [run.feeds[f].edit(run.entries[t][f], book) for f in order]
        for e in edits:
            inputs = e(inputs)
        want = ref.global_region(fam, inputs["x_m"], inputs["x_c"],
                                 inputs["alive"], knob["eps"])
        region_bad += int((want.cpu().numpy() != recs["region"]).sum())
        if t in run.checked_ticks:
            r, s = _replay(run, t, edits, _tables(book, device), fam, knob,
                           device, dtype)
            rec_bad, state_bad, checked = (rec_bad + r, state_bad + s,
                                           checked + 1)
    out = {"region_mismatch": region_bad, "record_mismatch": rec_bad,
           "state_mismatch": state_bad}
    out.update(run.faults)
    if run.dynamic:
        bad = out.get("membership_mismatch", 0)
        for mine, theirs in zip((book.nbr, book.mask, book.rev),
                                run.final_tables):
            bad += int((mine != theirs).sum())
        out["membership_mismatch"] = bad
    return out, checked
