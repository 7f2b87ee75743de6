"""Halo exchange of boundary out-messages between shards (port of
``repro/engine/exchange.py``: the single-device gather fallback, the
bounded-staleness ring of the async mode and the four wire formats).

The sender gathers its boundary slots into a dense ``(S, S, H)`` buffer
(src-major: ``buf[s, t, h]`` = h-th message from shard ``s`` to shard
``t``), the buffer is transposed across the (src, dst) axes, and the
receiver scatters ``buf[t, s, h]`` into its in-slots via the dst-major
``recv_*`` tables.  Messages whose ``delivered`` flag is False (not
pending, dead endpoint, dropped in flight, or table padding) are
discarded.  JAX discards them with an out-of-bounds ``mode="drop"``
scatter; torch has no such mode, so they are written to one extra dummy
row appended to the flattened target and sliced off (:func:`_scatter_flat`).
A real in-slot has a unique source out-slot, so at most one message
targets it per cycle: only the dummy row sees duplicate indices, and no
write races.  The error-feedback and sequence scatters do the same.

The sync exchange also takes Q tenants' stacked buffers (``batch=1``: a
leading tenant axis on every state array and buffer, one set of tables
for all of them), which the JAX service gets from ``vmap``.  The shard
axes are then axes 1 and 2 (:func:`transpose_all_to_all` swaps those,
never the tenant axis), the flags and so the scatter targets differ per
tenant, and the flattened ``(Q*S*B*D)`` target keeps ONE dummy row: every
tenant's discarded entries go there (:func:`_tenant_rows`), none lands in
another tenant's rows.

:func:`transpose_all_to_all` is the single-device transport: the whole
buffer lives on one device and the "exchange" is a transpose.
:func:`collective_all_to_all` is the transport across processes (one
shard a rank, :meth:`~repro_torch.engine.ShardedLSS.use_mesh`): each rank
holds its shard's src-major ``(S, H, ...)`` rows, and one
``all_to_all_single`` over a ``torch.distributed`` group sends chunk ``t``
to rank ``t``, so afterwards row ``s`` is what shard ``s`` sent here: the
dst-major rows :func:`scatter_block` takes.  A collective moves bytes, so
every dtype of every wire crosses it; a gloo group given CUDA tensors
moves them through pinned host memory
(:func:`repro_torch.distributed.collective.staged_bytes` counts them), an
NCCL group moves device memory.

Async mode publishes each cycle's send buffers into a ring of
``R = staleness + 1`` slots per sender (:func:`ring_publish`) and each
receiver reads every sender at a bounded-stale slot of its choosing
(:func:`ring_read`); :func:`scatter_seq` records the sequence numbers the
receiver applied, which Alg. 1's guard compares against.

Wire formats
------------

What crosses the transport is pluggable (:func:`get_wire`,
``EngineConfig(wire=...)``): the gathered ``(buf_m, buf_c, flag)`` triple is
``encode``-d into a payload tuple, each payload tensor is transposed, and
the receiver ``decode``-s it back before the scatter.  ``encode`` also
takes and returns the sender's error-feedback buffers (in halo
coordinates; :func:`gather_err` / :func:`scatter_err` move them to and from
the per-out-slot state), which only the stateful wires update.

===========  ==============================================================
``exact``    the triple itself — f32 values, bool flags.  The default.
``compact``  lossless: the ``delivered`` flags bit-pack 8-to-a-byte
             (:func:`pack_bits`) and the engine trims the halo tables to
             the occupied width.  Message values are bitwise unchanged.
``int8``     per-link symmetric int8 quantization of the value buffers
             with error feedback in per-out-slot state
             (:func:`repro_torch.distributed.compression.quantize_halo`);
             round-trip error at most ``scale / 2`` per component.
``bf16``     like ``int8`` but a bfloat16 cast (no scales): relative
             error at most ``2^-8`` per component, same error feedback.
===========  ==============================================================

``pair_bytes`` is each format's host-side traffic model: modeled wire
bytes per cycle for every ordered shard pair.

On one device the transport is a transpose in device memory, so the
compact and quantized wires save no bytes there: their encode and decode
are extra launches, and what they change is the trimmed tables and the
modeled ``pair_bytes``.  The saving is real only under the collective
transport, which moves the encoded payload between processes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..distributed import collective
from ..distributed.compression import dequantize_halo, quantize_halo
from .partition import HaloTables

__all__ = [
    "gather_halo",
    "gather_rows",
    "scatter_halo",
    "transpose_all_to_all",
    "collective_all_to_all",
    "gather_block",
    "scatter_block",
    "ring_publish",
    "ring_read",
    "scatter_seq",
    "pack_bits",
    "unpack_bits",
    "gather_err",
    "scatter_err",
    "scatter_err_block",
    "ring_read_column",
    "scatter_seq_block",
    "get_wire",
    "WIRE_FORMATS",
]


def _scatter_flat(flat, idx, vals):
    """``flat[idx] = vals`` on a copy with one dummy row appended; ``idx``
    sends discarded entries to that row, which is dropped.  ``flat`` is
    ``(N,)`` or ``(N, d)``; ``vals`` holds ``idx.numel()`` rows."""
    new = torch.cat([flat, flat.new_zeros((1, *flat.shape[1:]))])
    new[idx] = vals.reshape(idx.shape[0], *flat.shape[1:])
    return new[:-1]


def _tenant_rows(idx, q: int, n: int):
    """Per-tenant flat indices into ``n`` slots (``n`` = the dummy),
    ``(M,)`` shared or ``(q, M)`` -> indices into the ``q*n`` slots of all
    tenants, every dummy mapped to the one dummy row ``q*n`` (an offset
    dummy ``n + q*t`` would be tenant ``t + 1``'s first slot)."""
    idx = idx.expand(q, -1) if idx.ndim == 1 else idx.reshape(q, -1)
    off = torch.arange(q, device=idx.device)[:, None] * n
    return torch.where(idx == n, q * n, idx + off).reshape(-1)


def _scatter_pair(a_m, a_c, idx, val_m, val_c, batch=0):
    """:func:`_scatter_flat` of a ``(..., D, d)`` / ``(..., D)`` pair
    through their flattened slots; with ``batch=1`` the leading axis is
    the tenants' and ``idx`` holds per-tenant indices (see
    :func:`_tenant_rows`)."""
    n = a_c.numel()
    if batch:
        idx = _tenant_rows(idx, a_c.shape[0], n // a_c.shape[0])
    new_m = _scatter_flat(a_m.reshape(n, -1), idx, val_m)
    new_c = _scatter_flat(a_c.reshape(n), idx, val_c)
    return new_m.reshape(a_m.shape), new_c.reshape(a_c.shape)


def _block_index(flag, row, slot, B, D):
    """Flat ``(B*D)`` target index of one shard's ``(S, H)`` table entries;
    entries with ``flag`` False go to the dummy row ``B*D``."""
    return torch.where(flag, row.to(torch.int64) * D + slot,
                       B * D).reshape(-1)


def _full_index(flag, row, slot, S, B, D):
    """:func:`_block_index` of every shard's ``(S, S, H)`` tables into the
    flat ``(S*B*D)`` layout; the dummy row is ``S*B*D``.  Flags with a
    leading tenant axis give one index row per tenant."""
    shard = torch.arange(S, device=row.device)[:, None, None]
    return torch.where(flag, (shard * B + row) * D + slot,
                       S * B * D).reshape(*flag.shape[:-3], -1)


# -- per-shard (block-local) halves ----------------------------------------

def gather_block(out_m, out_c, delivered, send_row, send_slot, send_ok):
    """Boundary slots of ONE shard -> (S, H) send buffers.

    ``out_m (B, D, d)``, ``out_c/delivered (B, D)``; tables ``(S, H)``.
    """
    buf_m = out_m[send_row, send_slot]  # (S, H, d)
    buf_c = out_c[send_row, send_slot]  # (S, H)
    flag = delivered[send_row, send_slot] & send_ok
    return buf_m, buf_c, flag


def scatter_block(in_m, in_c, buf_m, buf_c, flag, recv_row, recv_slot):
    """Received (S, H) buffers -> in-slots of ONE shard (B, D, ...)."""
    B, D = in_c.shape
    return _scatter_pair(in_m, in_c,
                         _block_index(flag, recv_row, recv_slot, B, D),
                         buf_m, buf_c)


# -- full-array wrappers: every shard at once ------------------------------

def gather_rows(row, slot, *arrays, batch=0):
    """``a[s, row[s], slot[s]]`` of every shard for each of ``arrays``:
    ``(S, B, D, ...)`` -> ``(S, S, H, ...)`` through ``(S, S, H)`` tables
    (one shard index for all of them); ``(Q, S, B, D, ...)`` -> ``(Q, S,
    S, H, ...)`` with ``batch=1``."""
    shard = torch.arange(row.shape[0], device=row.device)[:, None, None]
    at = (slice(None),) * batch + (shard, row, slot)
    return tuple(a[at] for a in arrays)


def gather_halo(out_m, out_c, delivered, halo: HaloTables, batch=0):
    """:func:`gather_block` of every shard, by advanced indexing over the
    shard axis: ``(S, B, D, ...)`` -> src-major ``(S, S, H, ...)`` (each
    with ``batch`` leading tenant axes)."""
    buf_m, buf_c, sent = gather_rows(halo.send_row, halo.send_slot, out_m,
                                     out_c, delivered, batch=batch)
    return buf_m, buf_c, sent & halo.send_ok


def scatter_halo(in_m, in_c, buf_m, buf_c, flag, halo: HaloTables,
                 batch=0):
    """:func:`scatter_block` of every shard; buffers must already be
    dst-major ``(S_dst, S_src, H, ...)`` (each with ``batch`` leading
    tenant axes).  Returns new tensors."""
    S, B, D = in_c.shape[batch:]
    return _scatter_pair(in_m, in_c,
                         _full_index(flag, halo.recv_row, halo.recv_slot,
                                     S, B, D),
                         buf_m, buf_c, batch)


def transpose_all_to_all(buf, batch=0):
    """Single-device transport: (src, dst, ...) -> (dst, src, ...), after
    ``batch`` leading tenant axes."""
    return buf.transpose(batch, batch + 1)


# -- collective transport (one shard a process) ---------------------------

def collective_all_to_all(buf, group):
    """Cross-process transport of one shard's src-major ``(S, H, ...)``
    rows: chunk ``t`` goes to rank ``t`` of ``group``, and row ``s`` of the
    result is what rank ``s`` sent here (JAX's ``all_to_all`` with
    ``split_axis=0, concat_axis=0``).  Any dtype; through pinned host
    memory on a gloo group given CUDA tensors."""
    return collective.all_to_all(buf, group)


# -- bounded-staleness ring (async engine mode) ----------------------------
#
# Every shard publishes its send buffers into a ring of R = staleness + 1
# slots keyed by its own clock, and each receiver reads every sender's
# ring at a bounded-stale clock of its choosing.  A slot written at sender
# time c is overwritten at time c + R, so any read with delay <= staleness
# lands on an intact publication; skipped publications age out, and the
# sequence guard (scatter_seq + the seq-vs-last test) drops reordered ones.

def ring_publish(ring_m, ring_c, ring_flag, ring_seq, slot,
                 buf_m, buf_c, flag, seq):
    """Write each shard's (S, H) send buffers into its own ring slot.

    ``ring_*``: ``(R, S_src, S_dst, H[, d])``; ``slot``: (S,) per-shard
    write index (``clock % R``).  The whole row is overwritten, flags of
    the aged-out publication included.

    Unlike the rest of the engine this writes IN PLACE into the rings it
    is given (only the written slot moves) and returns them: the engine
    hands it rings it owns (:meth:`~repro_torch.engine.ShardedLSS.run`
    copies the caller's once per call).
    """
    src = torch.arange(slot.shape[0], device=slot.device)
    slot = slot.to(torch.int64)
    for ring, buf in ((ring_m, buf_m), (ring_c, buf_c),
                      (ring_flag, flag), (ring_seq, seq)):
        ring[slot, src] = buf
    return ring_m, ring_c, ring_flag, ring_seq


def ring_read(ring_m, ring_c, ring_flag, ring_seq, slot):
    """Read, for every (dst, src) pair, src's publication at
    ``slot[dst, src]`` — the receiver-chosen, bounded-stale sender time.

    Returns dst-major ``(S_dst, S_src, H[, d])`` buffers, the layout
    :func:`scatter_halo` consumes (at delay 0 this is exactly
    :func:`transpose_all_to_all` of the just-published buffers).
    """
    S = slot.shape[0]
    ar = torch.arange(S, device=slot.device)
    dst, src = torch.meshgrid(ar, ar, indexing="ij")
    slot = slot.to(torch.int64)
    return (ring_m[slot, src, dst], ring_c[slot, src, dst],
            ring_flag[slot, src, dst], ring_seq[slot, src, dst])


def ring_read_column(ring_m, ring_c, ring_flag, ring_seq, slot):
    """One receiver's row of :func:`ring_read`: its ring column ``(R,
    S_src, 1, H[, d])`` (the messages addressed to it) read at
    ``slot[src]``.  Returns src-major ``(S_src, H[, d])`` buffers, the
    layout :func:`scatter_block` consumes."""
    src = torch.arange(slot.shape[0], device=slot.device)
    slot = slot.to(torch.int64)
    return tuple(r[slot, src, 0] for r in (ring_m, ring_c, ring_flag,
                                            ring_seq))


def scatter_seq_block(last_seq, seq, flag, recv_row, recv_slot):
    """:func:`scatter_seq` of ONE shard: ``last_seq (B, D)``, received
    ``(S_src, H)`` entries.  Returns a new tensor."""
    B, D = last_seq.shape
    idx = _block_index(flag, recv_row, recv_slot, B, D)
    return _scatter_flat(last_seq.reshape(-1), idx, seq).reshape(B, D)


def scatter_seq(last_seq, seq, flag, recv_row, recv_slot):
    """Record applied sequence numbers per in-slot, every shard at once.

    ``last_seq (S, B, D)`` holds the newest seq applied into each in-slot;
    accepted messages (``flag``, dst-major ``(S, S, H)``) write their seq.
    Each in-slot has a unique source out-slot, so at most one message
    targets it per cycle.  Returns a new tensor.
    """
    S, B, D = last_seq.shape
    idx = _full_index(flag, recv_row, recv_slot, S, B, D)
    return _scatter_flat(last_seq.reshape(-1), idx, seq).reshape(S, B, D)


# -- error feedback in out-slot coordinates --------------------------------

def gather_err(err_m, err_c, halo: HaloTables, batch=0):
    """Per-out-slot error-feedback buffers -> src-major halo coordinates.

    ``err_m (S, B, D, d)`` / ``err_c (S, B, D)`` (after ``batch`` leading
    tenant axes) live in out-slot coordinates (independent of the halo
    width); each halo table entry reads its sending out-slot's running
    error, as :func:`gather_halo` reads ``out_m``.
    """
    return gather_rows(halo.send_row, halo.send_slot, err_m, err_c,
                       batch=batch)


def scatter_err_block(err_m, err_c, new_m, new_c, send_row, send_slot,
                      send_ok):
    """Write ONE shard's updated error feedback back to out-slot coords.

    Entries beyond the real table (``~send_ok``) go to the dummy row; an
    out-slot appears in at most one table entry, so writes never race.
    """
    B, D = err_c.shape
    return _scatter_pair(err_m, err_c,
                         _block_index(send_ok, send_row, send_slot, B, D),
                         new_m, new_c)


def scatter_err(err_m, err_c, new_m, new_c, halo: HaloTables, batch=0):
    """:func:`scatter_err_block` of every shard (src-major tables), after
    ``batch`` leading tenant axes."""
    S, B, D = err_c.shape[batch:]
    return _scatter_pair(err_m, err_c,
                         _full_index(halo.send_ok, halo.send_row,
                                     halo.send_slot, S, B, D),
                         new_m, new_c, batch)


# -- wire formats ----------------------------------------------------------

def pack_bits(flag):
    """bool ``(..., W)`` -> uint8 ``(..., ceil(W/8))``, little-endian.

    Bit ``h`` of byte ``b`` is flag ``b * 8 + h``; the tail byte pads
    with zeros.  Inverse: :func:`unpack_bits`.
    """
    W = flag.shape[-1]
    nbytes = -(-W // 8)
    pad = nbytes * 8 - W
    f = flag
    if pad:
        f = torch.cat([f, f.new_zeros((*f.shape[:-1], pad))], dim=-1)
    bits = f.reshape(*f.shape[:-1], nbytes, 8).to(torch.int32)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=flag.device)
    return torch.sum(bits * weights, dim=-1).to(torch.uint8)


def unpack_bits(packed, width: int):
    """uint8 ``(..., ceil(width/8))`` -> bool ``(..., width)``."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = torch.bitwise_and(
        torch.bitwise_right_shift(packed[..., :, None], shifts), 1)
    flat = bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8)
    return flat[..., :width].to(torch.bool)


class _ExactWire:
    """The f32 path: encode/decode are identities, the dense buffer ships
    whole (padding and ``halo_slack`` headroom as real bytes)."""

    name = "exact"
    lossy = False  # message values survive the wire bitwise
    stateful = False  # no error-feedback state
    trims = False  # tables stay at the full padded halo width
    quant_eps = 0.0  # per-component relative round-trip error bound

    #: serialized bytes per message slot for d-vector payloads:
    #: f32 moment vector + f32 weight + 1-byte flag.
    @staticmethod
    def _slot_bytes(d: int) -> int:
        return 4 * d + 4 + 1

    def encode(self, buf_m, buf_c, flag, err_m=None, err_c=None):
        return (buf_m, buf_c, flag), err_m, err_c

    def decode(self, payload):
        return payload

    def pair_bytes(self, counts: np.ndarray, width: int,
                   d: int) -> np.ndarray:
        """Modeled wire bytes per cycle per ordered (src, dst) pair.

        The dense row ships whole for every off-diagonal pair — occupancy
        (``counts``) does not matter, which is exactly the waste the
        other formats remove.
        """
        S = counts.shape[0]
        out = np.full((S, S), width * self._slot_bytes(d), np.int64)
        np.fill_diagonal(out, 0)  # the s -> s chunk never leaves the shard
        return out


class _CompactWire(_ExactWire):
    """Lossless byte reduction: bit-packed flags + occupied-width-only
    transport (the engine trims the halo tables to the used width, and
    the byte model ships each pair at its own ``H[s, t]``)."""

    name = "compact"
    trims = True

    def encode(self, buf_m, buf_c, flag, err_m=None, err_c=None):
        return (buf_m, buf_c, pack_bits(flag)), err_m, err_c

    def decode(self, payload):
        buf_m, buf_c, packed = payload
        return buf_m, buf_c, unpack_bits(packed, buf_c.shape[-1])

    def pair_bytes(self, counts, width, d):
        """Per pair: a 4-byte width header + ``ceil(H[s,t]/8)`` flag
        bytes + ``H[s,t]`` f32 message slots; silent pairs ship nothing."""
        c = counts.astype(np.int64)
        out = np.where(c > 0, c * (4 * d + 4) + (c + 7) // 8 + 4, 0)
        np.fill_diagonal(out, 0)
        return out


class _Int8Wire(_CompactWire):
    """Per-link symmetric int8 quantization with error feedback.

    Each (src, dst) link quantizes its value buffers against its own scale
    (``max|x + err| / 127``); the per-component round-trip error is at
    most ``scale / 2`` and is carried forward in the sender's error
    feedback, so it perturbs mass and never loses it.  ``quant_eps`` is
    the relative form of that bound.
    """

    name = "int8"
    lossy = True
    stateful = True
    quant_eps = 1.0 / 254.0  # scale/2 with scale = max|x + err| / 127

    def encode(self, buf_m, buf_c, flag, err_m=None, err_c=None):
        pack, new_err_m, new_err_c = quantize_halo(buf_m, buf_c, flag,
                                                   err_m, err_c)
        return (*pack, pack_bits(flag)), new_err_m, new_err_c

    def decode(self, payload):
        q_m, q_c, scale_m, scale_c, packed = payload
        buf_m, buf_c = dequantize_halo(q_m, q_c, scale_m, scale_c)
        return buf_m, buf_c, unpack_bits(packed, q_c.shape[-1])

    def pair_bytes(self, counts, width, d):
        """int8 payloads + two f32 per-link scales + packed flags."""
        c = counts.astype(np.int64)
        out = np.where(c > 0, c * (d + 1) + 8 + (c + 7) // 8 + 4, 0)
        np.fill_diagonal(out, 0)
        return out


class _Bf16Wire(_CompactWire):
    """bfloat16 cast with error feedback: 2x value bytes, no scales;
    relative per-component error at most ``2^-8`` (8-bit significand,
    round to nearest even)."""

    name = "bf16"
    lossy = True
    stateful = True
    quant_eps = 2.0 ** -8

    def encode(self, buf_m, buf_c, flag, err_m=None, err_c=None):
        f32 = torch.float32
        xm = buf_m.to(f32) if err_m is None else buf_m.to(f32) + err_m
        xc = buf_c.to(f32) if err_c is None else buf_c.to(f32) + err_c
        bm, bc = xm.to(torch.bfloat16), xc.to(torch.bfloat16)
        new_err_m = torch.where(flag[..., None], xm - bm.to(f32),
                                0.0 if err_m is None else err_m)
        new_err_c = torch.where(flag, xc - bc.to(f32),
                                0.0 if err_c is None else err_c)
        return (bm, bc, pack_bits(flag)), new_err_m, new_err_c

    def decode(self, payload):
        bm, bc, packed = payload
        return (bm.to(torch.float32), bc.to(torch.float32),
                unpack_bits(packed, bc.shape[-1]))

    def pair_bytes(self, counts, width, d):
        c = counts.astype(np.int64)
        out = np.where(c > 0, c * (2 * d + 2) + (c + 7) // 8 + 4, 0)
        np.fill_diagonal(out, 0)
        return out


WIRE_FORMATS = {w.name: w for w in
                (_ExactWire(), _CompactWire(), _Int8Wire(), _Bf16Wire())}


def get_wire(name: str):
    """Resolve a wire-format name (``EngineConfig.wire``) to its
    singleton wire object."""
    try:
        return WIRE_FORMATS[name]
    except KeyError:
        raise ValueError(
            f"unknown wire format {name!r}; "
            f"expected one of {sorted(WIRE_FORMATS)}") from None
