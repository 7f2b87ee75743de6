"""Plain reference of the monitor's per-tenant semantics (Alg. 1).

A self-contained restatement of the paper's LSS cycle in plain PyTorch, on a
stack of tenants: deliver, status and violations (Def. 4 / Alg. 1), the
selective correction do-while (Eq. 8, Eq. 10) and the observe (accuracy,
quiescence, the region of the global average).  It imports nothing of the
program: the slot tables come from :mod:`.topo`, the inputs from the
benchmark's generators.

The arithmetic follows the order the monitor is specified in: a peer's slots
are summed in slot order, one rounded add at a time; a dot product in
coordinate order, each product rounded on its own; the global average is
summed in float64 and rounded once.  ``dtype`` is the precision every
floating state and knob is held in (float32 as configured; a lower one for
the control).

State is a dict of tensors with a leading tenant axis Q:
``out_m``/``in_m`` (Q, n, D, d), ``out_c``/``in_c`` (Q, n, D), ``x_m``
(Q, n, d), ``x_c`` (Q, n), ``pending`` (Q, n, D) bool, ``last_send`` (Q, n)
int32, ``alive`` (Q, n) bool, ``t`` (Q,) int32, ``msgs`` (Q,) int64.
"""

from __future__ import annotations

import torch

COLD_TIMER = -(10 ** 6)
FIELDS = ("out_m", "out_c", "in_m", "in_c", "x_m", "x_c", "pending",
          "last_send", "alive", "t", "msgs")
VORONOI, HALFSPACE = 0, 1


def _per(x, like):
    """A (Q,) knob shaped to meet ``like`` (Q, ...) tenant by tenant."""
    return x.reshape(x.shape + (1,) * (like.ndim - x.ndim))


def _slot_sum(x, dim):
    parts = x.unbind(dim)
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    return acc


def _dot(u, c):
    out = u[..., 0] * c[..., 0]
    for j in range(1, u.shape[-1]):
        out = out + u[..., j] * c[..., j]
    return out


class Families:
    """Q region families: ``kind`` (Q,) int, ``centers`` (Q, K, d) with
    validity ``cmask`` (Q, K), halfspace ``w`` (Q, d) and ``b`` (Q,)."""

    def __init__(self, kind, centers, cmask, w, b):
        self.kind, self.centers, self.cmask, self.w, self.b = (
            kind, centers, cmask, w, b)

    def to(self, device, dtype):
        return Families(self.kind.to(device), self.centers.to(device, dtype),
                        self.cmask.to(device), self.w.to(device, dtype),
                        self.b.to(device, dtype))

    def take(self, idx):
        return Families(self.kind[idx], self.centers[idx], self.cmask[idx],
                        self.w[idx], self.b[idx])

    def decide(self, v):
        """Region ids of ``v`` (Q, ..., d): the nearest valid center for a
        Voronoi family (first of equal minima), ``w . v >= b`` for a
        halfspace."""
        q, d = v.shape[0], v.shape[-1]
        flat = v.reshape(q, -1, d)
        scores = (-2.0 * _dot(flat[:, :, None, :], self.centers[:, None])
                  + _dot(self.centers, self.centers)[:, None, :])
        scores = torch.where(self.cmask[:, None, :], scores, torch.inf)
        vor = torch.argmin(scores, dim=-1).to(torch.int32)
        half = (_dot(flat, self.w[:, None, :]) >= self.b[:, None]).to(
            torch.int32)
        out = torch.where(self.kind[:, None] == VORONOI, vor, half)
        return out.reshape(v.shape[:-1])


def _vec(m, c, eps):
    ok = torch.abs(c) > _per(eps, c)
    v = m / torch.where(ok, c, 1.0)[..., None]
    return torch.where(ok[..., None], v, 0.0)


def live_mask(tables, alive):
    nbr, mask, _ = tables
    return mask & alive[..., :, None] & alive[..., nbr]


def status(st, out_m, out_c, live):
    s_m = st["x_m"] + _slot_sum(
        torch.where(live[..., None], st["in_m"] - out_m, 0.0), dim=-2)
    s_c = st["x_c"] + _slot_sum(
        torch.where(live, st["in_c"] - out_c, 0.0), dim=-1)
    return s_m, s_c


def violations(fam, s_m, s_c, a_m, a_c, live, eps):
    region = fam.decide(_vec(s_m, s_c, eps))
    sa_m, sa_c = s_m[..., None, :] - a_m, s_c[..., None] - a_c
    a_zero = torch.abs(a_c) <= _per(eps, a_c)
    sa_zero = torch.abs(sa_c) <= _per(eps, sa_c)
    a_bad = ~a_zero & (fam.decide(_vec(a_m, a_c, eps)) != region[..., None])
    sa_bad = ~sa_zero & (fam.decide(_vec(sa_m, sa_c, eps))
                         != region[..., None])
    return (a_zero | a_bad | sa_bad) & live


def corrected(s_m, s_c, a_m, a_c, in_m, in_c, v, beta, eps):
    """Eq. 10 on the target T = S (+) (+)_{k in V} A_k (Eq. 8)."""
    t_m = s_m + _slot_sum(torch.where(v[..., None], a_m, 0.0), dim=-2)
    t_c = s_c + _slot_sum(torch.where(v, a_c, 0.0), dim=-1)
    nv = torch.clamp(torch.sum(v, dim=-1), min=1)
    inc = (s_c - _per(beta, s_c)) / (2.0 * nv.to(s_c.dtype))
    w_new = a_c + inc[..., None]
    safe = torch.where(torch.abs(t_c) > _per(eps, t_c), t_c, 1.0)
    scale = w_new / safe[..., None]
    return (scale[..., None] * t_m[..., None, :] - in_m,
            scale * t_c[..., None] - in_c)


def cycle(st, tables, fam, knobs):
    """One synchronous cycle of every tenant; returns the new state.
    ``knobs`` holds (Q,) ``beta``, ``eps`` and ``ell``."""
    nbr, mask, rev = tables
    beta, eps, ell = knobs["beta"], knobs["eps"], knobs["ell"]
    q, n, D = st["pending"].shape
    # Deliver: the message of slot (i, k) lands in slot (nbr, rev).
    live = live_mask(tables, st["alive"])
    send = st["pending"] & live
    src = nbr.to(torch.int64) * D + rev.to(torch.int64)
    got = send.reshape(q, n * D)[..., src] & mask
    d = st["x_m"].shape[-1]
    st = dict(st)
    st["in_m"] = torch.where(got[..., None],
                             st["out_m"].reshape(q, n * D, d)[..., src, :],
                             st["in_m"])
    st["in_c"] = torch.where(got, st["out_c"].reshape(q, n * D)[..., src],
                             st["in_c"])
    st["msgs"] = st["msgs"] + torch.sum(send, dim=(-2, -1)).to(torch.int64)
    st["pending"] = torch.zeros_like(st["pending"])
    # Status, violations, the do-while.
    s_m, s_c = status(st, st["out_m"], st["out_c"], live)
    a_m, a_c = st["out_m"] + st["in_m"], st["out_c"] + st["in_c"]
    viol = violations(fam, s_m, s_c, a_m, a_c, live, eps)
    timer_ok = (st["t"][:, None] - st["last_send"]) >= _per(
        ell, st["last_send"])
    active = st["alive"] & timer_ok & torch.any(viol, dim=-1)
    v = viol & active[..., None]
    running = active & torch.any(v, dim=-1)

    def apply(v):
        new_m, new_c = corrected(s_m, s_c, a_m, a_c, st["in_m"], st["in_c"],
                                 v, beta, eps)
        return (torch.where(v[..., None], new_m, st["out_m"]),
                torch.where(v, new_c, st["out_c"]))

    iters = 0
    while iters < D and bool(torch.any(running)):
        out_m, out_c = apply(v)
        s2_m, s2_c = status(st, out_m, out_c, live)
        viol2 = violations(fam, s2_m, s2_c, out_m + st["in_m"],
                           out_c + st["in_c"], live, eps)
        w = viol2 & running[..., None] & ~v
        running = running & torch.any(w, dim=-1)
        v = v | w
        iters += 1
    out_m, out_c = apply(v)
    did_send = active & torch.any(v, dim=-1)
    st["out_m"], st["out_c"] = out_m, out_c
    st["pending"] = st["pending"] | (v & did_send[..., None])
    st["last_send"] = torch.where(did_send, st["t"][:, None],
                                  st["last_send"])
    st["t"] = st["t"] + 1
    return st


def global_region(fam, x_m, x_c, alive, eps):
    """The region of the live peers' weighted average: the sums in
    float64, rounded once to the state's precision."""
    f64 = torch.float64
    gx_m = torch.sum(torch.where(alive[..., None], x_m, 0.0), dim=-2,
                     dtype=f64).to(x_m.dtype)
    gx_c = torch.sum(torch.where(alive, x_c, 0.0), dim=-1,
                     dtype=f64).to(x_c.dtype)
    return fam.decide(_vec(gx_m, gx_c, eps)[..., None, :])[..., 0]


def observe(st, tables, fam, knobs):
    """Each tenant's record: (accuracy, quiescent, region), (Q,) each."""
    eps = knobs["eps"]
    live = live_mask(tables, st["alive"])
    s_m, s_c = status(st, st["out_m"], st["out_c"], live)
    got = fam.decide(_vec(s_m, s_c, eps))
    viol = violations(fam, s_m, s_c, st["out_m"] + st["in_m"],
                      st["out_c"] + st["in_c"], live, eps)
    want = global_region(fam, st["x_m"], st["x_c"], st["alive"], eps)
    correct = (got == want[..., None]) & st["alive"]
    acc = (torch.sum(correct, dim=-1)
           / torch.clamp(torch.sum(st["alive"], dim=-1), min=1))
    quiescent = (~torch.any((st["pending"] & live).flatten(-2), dim=-1)
                 & ~torch.any(viol.flatten(-2), dim=-1))
    return acc, quiescent, want


def init_state(x_m, x_c, alive, D):
    """Every tenant fresh: S_i = X_ii, empty slots, cold send timers."""
    q, n, d = x_m.shape
    dev, dt = x_m.device, x_m.dtype
    return {
        "out_m": torch.zeros((q, n, D, d), dtype=dt, device=dev),
        "out_c": torch.zeros((q, n, D), dtype=dt, device=dev),
        "in_m": torch.zeros((q, n, D, d), dtype=dt, device=dev),
        "in_c": torch.zeros((q, n, D), dtype=dt, device=dev),
        "x_m": x_m, "x_c": x_c,
        "pending": torch.zeros((q, n, D), dtype=torch.bool, device=dev),
        "last_send": torch.full((q, n), COLD_TIMER, dtype=torch.int32,
                                device=dev),
        "alive": alive,
        "t": torch.zeros((q,), dtype=torch.int32, device=dev),
        "msgs": torch.zeros((q,), dtype=torch.int64, device=dev),
    }


def ingest_set(st, who, values, weights=None):
    """A ``set`` update: ``x[:, who] = <w * v, w>`` in every tenant."""
    st = dict(st)
    x_m, x_c = st["x_m"].clone(), st["x_c"].clone()
    who = torch.as_tensor(who, dtype=torch.long, device=x_m.device)
    vals = torch.as_tensor(values, device=x_m.device).to(x_m.dtype)
    w = (torch.ones(who.shape, dtype=x_c.dtype, device=x_c.device)
         if weights is None else torch.as_tensor(weights).to(x_c))
    x_m[:, who] = vals * w[:, None]
    x_c[:, who] = w
    st["x_m"], st["x_c"] = x_m, x_c
    return st


def apply_membership(st, touched, joins, leaves):
    """A boundary's membership edits in every tenant: the touched
    ``(row, slot)`` pairs scrubbed empty, ``leaves`` dead, ``joins`` alive
    with the knowledge-init input <0, 1> and a cold timer.  ``st`` may
    hold only some fields (the inputs alone: ``x_m``, ``x_c``,
    ``alive``); the others are left out."""
    st = {k: v.clone() for k, v in st.items()}
    dev = st["x_m"].device
    if touched:
        rows = torch.tensor([r for r, _ in touched], dtype=torch.long,
                            device=dev)
        slots = torch.tensor([s for _, s in touched], dtype=torch.long,
                             device=dev)
        for f in ("out_m", "out_c", "in_m", "in_c", "pending"):
            if f in st:
                st[f][:, rows, slots] = 0
    if leaves:
        st["alive"][:, torch.tensor(leaves, device=dev)] = False
    if joins:
        idx = torch.tensor(joins, device=dev)
        st["alive"][:, idx] = True
        st["x_m"][:, idx] = 0.0
        st["x_c"][:, idx] = 1.0
        if "last_send" in st:
            st["last_send"][:, idx] = COLD_TIMER
    return st


def tick(st, tables, fam, knobs, k):
    """K cycles, the observe, the window's sends and the counter reset.
    Returns (state after the tick, (accuracy, quiescent, region, msgs))."""
    for _ in range(k):
        st = cycle(st, tables, fam, knobs)
    acc, quiescent, want = observe(st, tables, fam, knobs)
    msgs = st["msgs"]
    st = dict(st)
    st["msgs"] = torch.zeros_like(msgs)
    return st, (acc, quiescent, want, msgs)


def cast(st, dtype):
    """The state with its floating fields in ``dtype``."""
    return {k: (v.to(dtype) if v.is_floating_point() else v)
            for k, v in st.items()}
