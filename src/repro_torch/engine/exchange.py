"""Halo exchange of boundary out-messages between shards (port of
``repro/engine/exchange.py``: the single-device gather fallback and the two
lossless wire formats).

The sender gathers its boundary slots into a dense ``(S, S, H)`` buffer
(src-major: ``buf[s, t, h]`` = h-th message from shard ``s`` to shard
``t``), the buffer is transposed across the (src, dst) axes, and the
receiver scatters ``buf[t, s, h]`` into its in-slots via the dst-major
``recv_*`` tables.  Messages whose ``delivered`` flag is False (not
pending, dead endpoint, dropped in flight, or table padding) are
discarded.  JAX discards them with an out-of-bounds ``mode="drop"``
scatter; torch has no such mode, so they are written to one extra dummy
row appended to the flattened in-slots and sliced off.  A real in-slot
has a unique source out-slot, so at most one message targets it per
cycle: only the dummy row sees duplicate indices, and no write races.

:func:`transpose_all_to_all` is the single-device transport: the whole
buffer lives on one device and the "exchange" is a transpose.  The
collective transport over several devices is ROADMAP A.5.

Wire formats
------------

What crosses the transport is pluggable (:func:`get_wire`,
``EngineConfig(wire=...)``): the gathered ``(buf_m, buf_c, flag)`` triple is
``encode``-d into a payload tuple, each payload tensor is transposed, and
the receiver ``decode``-s it back before the scatter.

===========  ==============================================================
``exact``    the triple itself — f32 values, bool flags.  The default.
``compact``  lossless: the ``delivered`` flags bit-pack 8-to-a-byte
             (:func:`pack_bits`) and the engine trims the halo tables to
             the occupied width.  Message values are bitwise unchanged.
===========  ==============================================================

``int8`` and ``bf16`` (quantized, with error feedback) are ROADMAP A.4b and
raise ``NotImplementedError``.  ``pair_bytes`` is each format's host-side
traffic model: modeled wire bytes per cycle for every ordered shard pair.

On one device the transport is a transpose in device memory, so ``compact``
saves no bytes there: its pack and unpack are extra launches, and what it
changes is the trimmed tables and the modeled ``pair_bytes``.  Its saving
is real only once a transport moves the payload between devices (A.5).
"""

from __future__ import annotations

import numpy as np
import torch

from .partition import HaloTables

__all__ = [
    "gather_halo",
    "scatter_halo",
    "transpose_all_to_all",
    "gather_block",
    "scatter_block",
    "pack_bits",
    "unpack_bits",
    "get_wire",
    "WIRE_FORMATS",
]


# -- per-shard (block-local) halves ----------------------------------------

def gather_block(out_m, out_c, delivered, send_row, send_slot, send_ok):
    """Boundary slots of ONE shard -> (S, H) send buffers.

    ``out_m (B, D, d)``, ``out_c/delivered (B, D)``; tables ``(S, H)``.
    """
    buf_m = out_m[send_row, send_slot]  # (S, H, d)
    buf_c = out_c[send_row, send_slot]  # (S, H)
    flag = delivered[send_row, send_slot] & send_ok
    return buf_m, buf_c, flag


def _scatter_rows(flat_m, flat_c, idx, buf_m, buf_c):
    """``flat_*[idx] = buf_*`` on copies with one dummy row appended;
    ``idx`` sends discarded entries to that row, which is dropped."""
    d = flat_m.shape[-1]
    new_m = torch.cat([flat_m, flat_m.new_zeros((1, d))])
    new_c = torch.cat([flat_c, flat_c.new_zeros((1,))])
    new_m[idx] = buf_m.reshape(-1, d)
    new_c[idx] = buf_c.reshape(-1)
    return new_m[:-1], new_c[:-1]


def scatter_block(in_m, in_c, buf_m, buf_c, flag, recv_row, recv_slot):
    """Received (S, H) buffers -> in-slots of ONE shard (B, D, ...)."""
    B, D = in_c.shape
    idx = torch.where(flag, recv_row.to(torch.int64) * D + recv_slot,
                      B * D).reshape(-1)
    new_m, new_c = _scatter_rows(in_m.reshape(B * D, -1),
                                 in_c.reshape(B * D), idx, buf_m, buf_c)
    return new_m.reshape(in_m.shape), new_c.reshape(in_c.shape)


# -- full-array wrappers: every shard at once ------------------------------

def gather_halo(out_m, out_c, delivered, halo: HaloTables):
    """:func:`gather_block` of every shard, by advanced indexing over the
    leading shard axis: ``(S, B, D, ...)`` -> src-major ``(S, S, H, ...)``."""
    shard = torch.arange(out_c.shape[0], device=out_c.device)[:, None, None]
    buf_m = out_m[shard, halo.send_row, halo.send_slot]
    buf_c = out_c[shard, halo.send_row, halo.send_slot]
    flag = delivered[shard, halo.send_row, halo.send_slot] & halo.send_ok
    return buf_m, buf_c, flag


def scatter_halo(in_m, in_c, buf_m, buf_c, flag, halo: HaloTables):
    """:func:`scatter_block` of every shard; buffers must already be
    dst-major ``(S_dst, S_src, H, ...)``.  Returns new tensors."""
    S, B, D = in_c.shape
    shard = torch.arange(S, device=in_c.device)[:, None, None]
    idx = torch.where(flag, (shard * B + halo.recv_row) * D + halo.recv_slot,
                      S * B * D).reshape(-1)
    new_m, new_c = _scatter_rows(in_m.reshape(S * B * D, -1),
                                 in_c.reshape(S * B * D), idx, buf_m, buf_c)
    return new_m.reshape(in_m.shape), new_c.reshape(in_c.shape)


def transpose_all_to_all(buf):
    """Single-device transport: (src, dst, ...) -> (dst, src, ...)."""
    return buf.transpose(0, 1)


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
    trims = False  # tables stay at the full padded halo width

    #: serialized bytes per message slot for d-vector payloads:
    #: f32 moment vector + f32 weight + 1-byte flag.
    @staticmethod
    def _slot_bytes(d: int) -> int:
        return 4 * d + 4 + 1

    def encode(self, buf_m, buf_c, flag):
        return buf_m, buf_c, flag

    def decode(self, payload):
        return payload

    def pair_bytes(self, counts: np.ndarray, width: int,
                   d: int) -> np.ndarray:
        """Modeled wire bytes per cycle per ordered (src, dst) pair.

        The dense row ships whole for every off-diagonal pair — occupancy
        (``counts``) does not matter, which is exactly the waste the
        compact format removes.
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

    def encode(self, buf_m, buf_c, flag):
        return buf_m, buf_c, pack_bits(flag)

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


WIRE_FORMATS = {w.name: w for w in (_ExactWire(), _CompactWire())}

# The quantized wires with their error-feedback state: not ported yet.
_UNPORTED_WIRES = ("int8", "bf16")


def get_wire(name: str):
    """Resolve a wire-format name (``EngineConfig.wire``) to its
    singleton wire object."""
    if name in _UNPORTED_WIRES:
        raise NotImplementedError(
            f"wire={name!r} (quantized halo with error feedback) is not "
            "ported yet (ROADMAP A.4b); use 'exact' or 'compact'")
    try:
        return WIRE_FORMATS[name]
    except KeyError:
        raise ValueError(
            f"unknown wire format {name!r}; expected one of "
            f"{sorted(WIRE_FORMATS) + list(_UNPORTED_WIRES)}") from None
