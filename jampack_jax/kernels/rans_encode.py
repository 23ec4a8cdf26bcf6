"""Device structured-rANS chunk encoder.

The encode side of ans.cpp:113-219, on device: a forward model pass turns
the chunk's RLE0 symbols into (low, freq) op pairs (same bit-exact model
bank as the decoder, rans_common.py), then a reverse pass pushes the pairs
through 4 interleaved rANS states (rans_byte.hpp:83-110 semantics) emitting
renormalization bytes backward into a fixed-size buffer.

Like decode, one chain is irreducibly serial; encode throughput comes from
vmapping chains — the chunks of a block in the reference layout, and
additionally the lanes inside each chunk in JTX wide-interleave streams.

Variable-length output on fixed shapes (survey §7 hard part 3): each op
emits 0-2 renorm bytes.  Emissions are recorded DENSELY by loop step
(dynamic_update_slice at 2*k — never a data-dependent in-loop scatter,
whose predicated form under vmap has silently lost writes on an earlier
accelerator backend) and materialized into the descending-pointer buffer
with ONE end-of-loop sort, like the decode side.  Worst-case
payload is bounded by 2 bytes/op amortized (16 bits of state growth per
op) + 16 flush bytes.

jax.vmap over a fori_loop whose TRIP COUNT is batched (per-lane rlen)
lowers to a masked while-loop with predicated in-loop writes; the form
used here is the decode side's instead: a HAND-WIDENED (L, ...) kernel with a SCALAR loop bound (max over lanes),
per-lane active masks, and shared-offset column dynamic_update_slices
(rans_reverse_encode_wide below).  The per-chain rans_reverse_encode is
kept for single-chain callers only.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..format.constants import (
    MODEL_SWITCH_THRESHOLD,
    PROB_BITS,
    RANS_BYTE_L,
)
from ..format.tables import LOG, MANTISSA
from .rans_common import NQ, exp_lookup, exp_update, init_bank, mant_lookup, \
    mant_update


@partial(jax.jit, static_argnames=("max_rlen",))
def model_chain_pairs(syms: jnp.ndarray, rlen: jnp.ndarray, max_rlen: int):
    """Forward model pass: (low, freq) per op, 2 ops per symbol
    (ans.cpp:152-187).  syms: uint16 padded to max_rlen."""
    log_t = jnp.asarray(LOG.astype(np.int32))
    mant_t = jnp.asarray(MANTISSA.astype(np.int32))
    lows = jnp.zeros(2 * max_rlen, dtype=jnp.int32)
    fqs = jnp.zeros(2 * max_rlen, dtype=jnp.int32)
    bank = init_bank()

    def body(i, carry):
        bank, lows, fqs, ok = carry
        sym = syms[i].astype(jnp.int32)
        e = log_t[sym]
        m = mant_t[sym]

        lo, fq = exp_lookup(bank, e)
        lows = lows.at[2 * i].set(lo)
        fqs = fqs.at[2 * i].set(fq)
        ok = jnp.logical_and(ok, fq > 0)
        bank = exp_update(bank, e)

        is_adaptive = e < MODEL_SWITCH_THRESHOLD
        ei = jnp.clip(e, 0, MODEL_SWITCH_THRESHOLD - 1)
        qi = jnp.clip(e - MODEL_SWITCH_THRESHOLD, 0, NQ - 1)
        lo, fq = mant_lookup(bank, ei, qi, is_adaptive, m)
        lows = lows.at[2 * i + 1].set(lo)
        fqs = fqs.at[2 * i + 1].set(fq)
        ok = jnp.logical_and(ok, fq > 0)
        bank = mant_update(bank, ei, qi, is_adaptive, m, m)
        return bank, lows, fqs, ok

    _, lows, fqs, ok = jax.lax.fori_loop(
        0, rlen, body, (bank, lows, fqs, jnp.bool_(True))
    )
    return lows, fqs, ok


@partial(jax.jit, static_argnames=("max_rlen",))
def rans_reverse_encode(lows: jnp.ndarray, fqs: jnp.ndarray,
                        rlen: jnp.ndarray, max_rlen: int):
    """Reverse pass: ops [0, 2*rlen) encoded back-to-front through 4
    rotating states (ans.cpp:189-208), bytes emitted backward.

    Returns (buf, ptr): payload is buf[ptr:] with buf sized 4*max_rlen+16.
    """
    size = 4 * max_rlen + 16
    ncap = 2 * max_rlen          # op-slot capacity
    scap = 2 * ncap + 16         # emission-slot capacity (== size)
    # single-operand packed sort (slot << 8 | byte) needs 24-bit slots —
    # holds up to 4 MB chunks (scap = 4*max_rlen+16); static guard
    assert scap < (1 << 24), "emission slots exceed the 24-bit pack range"
    R = jnp.full(4, RANS_BYTE_L, dtype=jnp.uint32)
    ptr = jnp.int32(size)
    nops = 2 * rlen
    # Emission record: slot s = 2*k + sub for op step k; ascending slot
    # order IS emission order (descending buffer addresses).  recs hold
    # (slot << 8 | byte) for emitted bytes, the sentinel 0xFFFFFFFF
    # otherwise — ONE u32 operand, the same packed-sort shape the decode
    # side already proves on real hardware (ibwt restride, Lpx undeal).
    recs = jnp.full(scap, jnp.uint32(0xFFFFFFFF))
    # one packed (low | freq << 16) word per op: halves the per-step
    # dynamic-index read (the loop's random-access cost under vmap)
    pairs = lows.astype(jnp.uint32) | (fqs.astype(jnp.uint32) << 16)

    def body(k, carry):
        R, recs, ptr = carry
        i = nops - 1 - k
        pf = pairs[i]
        fq = pf >> 16
        lo = pf & jnp.uint32(0xFFFF)
        x = R[3]
        # renormalize: emit low bytes while x >= x_max (rans_byte.hpp:83-95).
        # TWO emissions always suffice: pre-renorm x < 2^31 (the previous
        # advance is bounded by (x_max/fq) << 16 = 2^31) and x_max =
        # 2^15 * fq >= 2^15, so (x >> 16) < 2^15 <= x_max.
        x_max = ((jnp.uint32(RANS_BYTE_L) >> PROB_BITS) << 8) * fq
        need0 = x >= x_max
        b0 = x & jnp.uint32(0xFF)
        x = jnp.where(need0, x >> 8, x)
        need1 = x >= x_max
        b1 = x & jnp.uint32(0xFF)
        x = jnp.where(need1, x >> 8, x)
        x = ((x // fq) << PROB_BITS) + (x % fq) + lo
        R = jnp.stack([x, R[0], R[1], R[2]])
        # record both candidate emissions densely at slots 2k/2k+1 — a
        # dynamic_update_slice at the loop counter, never a scatter
        s0 = 2 * k
        su = jnp.uint32(2) * k.astype(jnp.uint32)
        rv = jnp.stack([
            jnp.where(need0, (su << 8) | b0, jnp.uint32(0xFFFFFFFF)),
            jnp.where(need1, ((su + 1) << 8) | b1, jnp.uint32(0xFFFFFFFF)),
        ])
        recs = jax.lax.dynamic_update_slice(recs, rv, (s0,))
        ptr = ptr - need0.astype(jnp.int32) - need1.astype(jnp.int32)
        return R, recs, ptr

    R, recs, ptr = jax.lax.fori_loop(0, nops, body, (R, recs, ptr))

    # flush R3..R0, little-endian 4 bytes each (rans_byte.hpp:98-110):
    # emission-order = descending addresses, so R3's MSB is emitted first;
    # the 16 flush slots live past every loop slot (static tail indices)
    jj = jnp.repeat(jnp.arange(3, -1, -1), 4)
    bb = jnp.tile(jnp.arange(3, -1, -1), 4)
    fbytes = (R[jj] >> (8 * bb).astype(jnp.uint32)) & 0xFF
    fslots = jnp.arange(2 * ncap, 2 * ncap + 16, dtype=jnp.uint32)
    recs = recs.at[2 * ncap:].set((fslots << 8) | fbytes)
    ptr = ptr - 16

    # materialize: ascending packed order puts the E emitted bytes first
    # in emission order (sentinels last); buf address of emission e is
    # size-1-e, so the buffer is the flipped (masked) sorted byte stream
    byts_s = (jax.lax.sort(recs) & 0xFF).astype(jnp.uint8)
    emitted = jnp.arange(scap, dtype=jnp.int32) < (jnp.int32(size) - ptr)
    buf = jnp.flip(jnp.where(emitted, byts_s, 0))
    return buf, ptr


@partial(jax.jit, static_argnames=("max_rlen",))
def rans_reverse_encode_wide(lows: jnp.ndarray, fqs: jnp.ndarray,
                             rlens: jnp.ndarray, max_rlen: int):
    """Reverse rANS for L chains in LOCKSTEP — the scalable form (see the
    module docstring's hardware rule): scalar loop bound, (L, 2) column
    writes at the shared offset 2*k, per-lane active masks, one per-lane
    packed sort at the end (the decode chain's proven shapes).

    lows/fqs: (L, 2*max_rlen) op pairs; rlens: (L,) symbol counts.
    Returns (bufs (L, 4*max_rlen+16) u8, ptrs (L,)): payload l is
    bufs[l, ptrs[l]:]."""
    L, _ = lows.shape
    size = 4 * max_rlen + 16
    ncap = 2 * max_rlen
    scap = 2 * ncap + 16
    assert scap < (1 << 24), "emission slots exceed the 24-bit pack range"
    R = jnp.full((L, 4), RANS_BYTE_L, dtype=jnp.uint32)
    ptr = jnp.full(L, size, jnp.int32)
    nops = 2 * rlens                                  # (L,)
    # step-major emission slab + transposed pair reads: the loop walks a
    # COMMON op index k DESCENDING from max(nops)-1 (every lane's reverse
    # order is just descending k, lanes with fewer ops activate late), so
    # the per-step pair fetch is a uniform ROW read of pairs_t — the old
    # form paid a per-step (L,) take_along_axis gather plus an L-strided
    # (L, 2) column write into (L, scap) (r5 slab-write lesson).
    recs_t = jnp.full((scap, L), jnp.uint32(0xFFFFFFFF))
    pairs_t = (lows.astype(jnp.uint32)
               | (fqs.astype(jnp.uint32) << 16)).T    # (ncap, L)

    steps = jnp.minimum(jnp.maximum(jnp.max(nops), 0), ncap)

    def body(kp, carry):
        R, recs_t, ptr = carry
        k = steps - 1 - kp                            # common op index
        active = k < nops
        pf = pairs_t[jnp.clip(k, 0, ncap - 1)]        # (L,) row read
        fq = jnp.maximum(pf >> 16, 1)                 # inactive lanes: inert
        lo = pf & jnp.uint32(0xFFFF)
        x = R[:, 3]
        x_max = ((jnp.uint32(RANS_BYTE_L) >> PROB_BITS) << 8) * fq
        need0 = active & (x >= x_max)
        b0 = x & jnp.uint32(0xFF)
        x = jnp.where(need0, x >> 8, x)
        need1 = active & (x >= x_max)
        b1 = x & jnp.uint32(0xFF)
        x = jnp.where(need1, x >> 8, x)
        x2 = ((x // fq) << PROB_BITS) + (x % fq) + lo
        # rotate ONLY active lanes: an inactive lane's 4 states must hold
        # still or its flush order scrambles
        rot = jnp.concatenate([x2[:, None], R[:, :3]], axis=1)
        R = jnp.where(active[:, None], rot, R)
        su = (2 * kp).astype(jnp.uint32)              # ascends with emission
        rv = jnp.stack([
            jnp.where(need0, (su << 8) | b0, jnp.uint32(0xFFFFFFFF)),
            jnp.where(need1, ((su + 1) << 8) | b1, jnp.uint32(0xFFFFFFFF)),
        ], axis=0)                                    # (2, L)
        recs_t = jax.lax.dynamic_update_slice(recs_t, rv, (2 * kp, 0))
        ptr = ptr - need0.astype(jnp.int32) - need1.astype(jnp.int32)
        return R, recs_t, ptr

    R, recs_t, ptr = jax.lax.fori_loop(0, steps, body, (R, recs_t, ptr))
    recs = recs_t.T

    # flush R3..R0 little-endian (rans_byte.hpp:98-110): emission order is
    # descending addresses, so R3's MSB first; static tail slots
    jj = jnp.repeat(jnp.arange(3, -1, -1), 4)
    bb = jnp.tile(jnp.arange(3, -1, -1), 4)
    fbytes = (R[:, jj] >> (8 * bb)[None, :].astype(jnp.uint32)) & 0xFF
    fslots = jnp.arange(2 * ncap, 2 * ncap + 16, dtype=jnp.uint32)
    recs = recs.at[:, 2 * ncap:].set((fslots[None, :] << 8) | fbytes)
    ptr = ptr - 16

    byts_s = (jax.lax.sort(recs, dimension=1) & 0xFF).astype(jnp.uint8)
    emitted = jnp.arange(scap, dtype=jnp.int32)[None, :] \
        < (jnp.int32(size) - ptr)[:, None]
    bufs = jnp.flip(jnp.where(emitted, byts_s, 0), axis=1)
    return bufs, ptr


def encode_pairs_device(syms: np.ndarray) -> bytes:
    """Host wrapper: encode one symbol chain on device (drop-in for
    stages.ans.encode_pairs)."""
    syms = np.asarray(syms, dtype=np.uint16)
    rlen = int(syms.size)
    max_rlen = max(rlen, 1)
    padded = np.zeros(max_rlen, dtype=np.uint16)
    padded[:rlen] = syms
    lows, fqs, ok = model_chain_pairs(
        jnp.asarray(padded), jnp.int32(rlen), max_rlen
    )
    if not bool(ok):
        raise ValueError(
            "model failure (CDF): chunk not encodable in ref-compat mode"
        )
    buf, ptr = rans_reverse_encode(lows, fqs, jnp.int32(rlen), max_rlen)
    return np.asarray(jax.device_get(buf)).tobytes()[int(ptr):]


@partial(jax.jit, static_argnames=("max_rlen",))
def _encode_lanes(syms_pad, rlens, max_rlen: int):
    from .rans_wide import model_pairs_wide

    lows, fqs, oks = model_pairs_wide(syms_pad, rlens, max_rlen)
    bufs, ptrs = rans_reverse_encode_wide(lows, fqs, rlens, max_rlen)
    return bufs, ptrs, oks


def encode_lanes_device(lane_syms) -> list:
    """Encode L symbol chains (the lanes of one JTX chunk) in lockstep.

    lane_syms: list of uint16 arrays.  Returns list of payload bytes.
    """
    L = len(lane_syms)
    max_rlen = max(max((s.size for s in lane_syms), default=0), 1)
    syms_pad = np.zeros((L, max_rlen), dtype=np.uint16)
    rlens = np.zeros(L, dtype=np.int32)
    for l, s in enumerate(lane_syms):
        syms_pad[l, : s.size] = s
        rlens[l] = s.size
    bufs, ptrs, oks = _encode_lanes(
        jnp.asarray(syms_pad), jnp.asarray(rlens), max_rlen
    )
    if not bool(jnp.all(oks)):
        raise ValueError(
            "model failure (CDF): chunk not encodable in ref-compat mode"
        )
    bufs = np.asarray(jax.device_get(bufs))
    ptrs = np.asarray(jax.device_get(ptrs))
    return [bufs[l].tobytes()[int(ptrs[l]):] for l in range(L)]
