"""Device Lpx — localized prefix model codec.

The reference splits the block into 4 equal sub-blocks each with
independent model state (lpx.cpp:150-169) — exactly a vmap axis here
(survey P7): the per-span byte loop is irreducibly serial (order-1..3
context tables update per byte), so the kernel runs the 4 spans in
lockstep, each step doing small-table gathers/updates and the XOR
prediction run logic as selects.

The reference's inner "emit XOR until first nonzero error" loop
(lpx.cpp:73-95) is flattened into carried state: `in_run` plus the run's
anchor distance, which the reference fixes at run entry.

Bit-exact with stages/lpx.py (and thus lpx.cpp): int32 arithmetic-shift
threshold mixing, uint32 wrap of the rolling context and anchor distance,
update-table order adjustment 1<->3.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..format.constants import (
    LPX_MAX_RECORD_SIZE,
    LPX_MAX_THRESHOLD,
    LPX_MIN_THRESHOLD,
)


# Field layout of the packed (4, 256, 5) table: one row per (order, prefix)
# holding (cxt, pos, hits, miss, thr); orders 1..3 live in slices 0..2 and
# slice 3 is a write-scratch slot (below).  All five fields share the
# (t, lp) index, so packing them turns every per-step table access into ONE
# row gather / scatter instead of five — under the spans vmap these are the
# per-step random-access ops, and batched gathers are the platform's cost
# center (CLAUDE.md walls).
_F_CXT, _F_POS, _F_HITS, _F_MISS, _F_THR = range(5)

# Number of order slices incl. the scratch row.
_T_SLICES = 4


def _update_table(tbl, cxt, pos, order, rows, active=True):
    """lpx.cpp:11-54 semantics on the packed (4, 256, 5) table; returns
    (tbl, new_order).

    `rows` is the (3, 5) pre-gathered slice [tbl[t,lp], tbl[t-1,lp],
    tbl[t+1,lp]] (clipped t±1) fetched by the caller BEFORE any write this
    step — every value this update needs is known up front, so the whole
    update is ONE two-row scatter with no read-after-write on the carried
    table (a gather of a freshly scattered buffer forces XLA to materialize
    a copy of the whole table every step; that copy was ~95% of the span
    loop's wall).  The trailing threshold update targets the POST-adjustment
    order's record (the reference re-derefs *order, lpx.cpp:29-52): when the
    order moved, that row was untouched by the primary write and the
    pre-gathered value is current; when it did not move, the primary row's
    just-computed fields are used directly and the second scatter row is
    parked in scratch slice 3.

    `active` gates the whole update: with it False every write stores the
    value already there and new_order == order."""
    o = order
    t = o - 1
    lp = (cxt >> (o * 8)).astype(jnp.int32) & 0xFF
    ls = (cxt & ((jnp.uint32(1) << (o * 8)) - 1)).astype(jnp.int32)

    row, row_dn, row_up = rows[0], rows[1], rows[2]
    r_cxt, r_pos, r_hits, r_miss, r_thr = (
        row[_F_CXT], row[_F_POS], row[_F_HITS], row[_F_MISS], row[_F_THR])

    distance = pos - r_pos
    lower = jnp.int32(LPX_MIN_THRESHOLD)
    upper = jnp.where(
        r_hits < LPX_MAX_THRESHOLD,
        jnp.maximum(distance, lower),
        jnp.minimum(distance >> o, LPX_MAX_THRESHOLD >> o),
    )
    bound = jnp.where(
        distance <= lower, lower, jnp.where(distance > upper, upper, distance)
    )

    gate = active & (pos > o)
    match = gate & (r_cxt == ls)
    mismatch = gate & (r_cxt != ls)

    # ---- primary-record updates (always the entry order's record)
    new_pos = jnp.where(match, pos - o, r_pos)
    new_hits = jnp.where(match, r_hits + 1, r_hits)
    new_miss = jnp.where(match, 0, r_miss)
    new_hits = jnp.where(mismatch, r_hits >> 2, new_hits)
    new_miss = jnp.where(mismatch, r_miss + 1, new_miss)
    new_cxt = jnp.where(mismatch, ls, r_cxt)

    o_down = match & (new_hits > ((r_thr << o) << 3)) & (o > 1) & (o <= 3)
    o_up = (
        mismatch
        & (new_miss > r_thr * r_thr * o)
        & (o >= 1) & (o < 3)
    )
    new_order = jnp.where(o_down, o - 1, jnp.where(o_up, o + 1, o))

    # ---- trailing threshold update on the new order's record
    tn = new_order - 1
    same = tn == t
    pre2 = jnp.where(tn < t, row_dn, row_up)  # valid whenever ~same
    h2 = jnp.where(same, new_hits, pre2[_F_HITS])
    m2 = jnp.where(same, new_miss, pre2[_F_MISS])
    th2 = jnp.where(same, r_thr, pre2[_F_THR])
    thr_up = match & (h2 > (th2 << 1)) & (m2 == 0)
    thr_m = th2 + ((bound - th2) >> new_order)
    thr_up2 = mismatch & (m2 > th2)
    thr_mm = th2 + ((LPX_MAX_THRESHOLD - th2) >> (4 - new_order))
    new_thr = jnp.where(thr_up, thr_m, jnp.where(thr_up2, thr_mm, th2))

    row_a = jnp.stack([new_cxt, new_pos, new_hits, new_miss,
                       jnp.where(same, new_thr, r_thr)])
    row_b = jnp.stack([pre2[_F_CXT], pre2[_F_POS], pre2[_F_HITS],
                       pre2[_F_MISS], new_thr])
    tb = jnp.where(same, jnp.int32(_T_SLICES - 1), tn)
    tbl = tbl.at[jnp.stack([t, tb]), jnp.stack([lp, lp])].set(
        jnp.stack([row_a, row_b]))
    return tbl, new_order


def _code_span(inp, length, max_len: int, decode: bool, steps=None):
    """One sub-block (lpx.cpp:73-95 flattened); inp padded to max_len.

    `steps` optionally bounds the loop with a traced value (pass the batch
    max length when max_len is a large static capacity — the body masks on
    `length`, so extra steps are no-ops but not free).

    Dispatches on the static span capacity: spans under 2^15 bytes (every
    JT3 wide-span stream; the per-span walk is the serial axis, so real
    streams keep spans SHORT) take the packed-record variant — all four
    counters of a record are bounded by the span length, so (pos, hits)
    and (miss, thr) pair into single int32 words and the per-step random
    table traffic drops from 30 gathered/scattered elements to 13."""
    if max_len <= 0x7FFF:
        return _code_span_packed(inp, length, max_len, decode, steps)
    return _code_span_wide(inp, length, max_len, decode, steps)


def _code_span_wide(inp, length, max_len: int, decode: bool, steps=None):
    """Unpacked-record variant (any span length)."""
    tbl = jnp.zeros((_T_SLICES, 256, 5), jnp.int32).at[:3, :, _F_THR].set(
        LPX_MAX_THRESHOLD >> 1)
    out = jnp.zeros(max_len, jnp.uint8)

    def body(i, carry):
        tbl, out, cxt, order, in_run, run_dist = carry
        active = i < length

        lp0 = (cxt & 0xFF).astype(jnp.int32)
        t = order - 1
        # ONE fused gather for everything the step reads from the table:
        # the run-detection row (t, lp0), the primary row (t, lp) and both
        # candidate trailing rows (t±1, lp) for _update_table
        lp = (cxt >> (order * 8)).astype(jnp.int32) & 0xFF
        g = tbl[jnp.stack([t, t, jnp.maximum(t - 1, 0),
                           jnp.minimum(t + 1, 2)]),
                jnp.stack([lp0, lp, lp, lp])]  # (4, 5)
        row0 = g[0]
        dist_new = (jnp.uint32(i) - row0[_F_POS].astype(jnp.uint32))
        start_run = (
            jnp.logical_not(in_run)
            & (row0[_F_HITS] > row0[_F_THR])
            & (dist_new < LPX_MAX_RECORD_SIZE)
        )
        coding = in_run | start_run
        dist = jnp.where(in_run, run_dist, dist_new).astype(jnp.int32)

        src = jnp.where(coding, i - dist, 0)
        ref_byte = (out[src] if decode else inp[src]).astype(jnp.uint8)
        cur = inp[i].astype(jnp.uint8)
        if decode:
            err = jnp.where(coding, cur, jnp.uint8(0))
            emitted = jnp.where(coding, ref_byte ^ cur, cur)
        else:
            err = jnp.where(coding, ref_byte ^ cur, jnp.uint8(0))
            emitted = jnp.where(coding, ref_byte ^ cur, cur)
        out = out.at[i].set(jnp.where(active, emitted, out[i]))

        # orig byte feeding the rolling context: reconstructed output while
        # decoding, the raw input while encoding (lpx.cpp run body)
        orig_byte = emitted if decode else cur

        tbl, new_order = _update_table(tbl, cxt, i, order, g[1:], active)
        order = new_order  # == order when inactive (gates are off)
        cxt = jnp.where(
            active, (cxt << 8) | orig_byte.astype(jnp.uint32), cxt
        )
        next_in_run = coding & (err == 0)
        in_run = jnp.where(active, next_in_run, in_run)
        run_dist = jnp.where(active & coding, dist.astype(jnp.uint32),
                             run_dist)
        return tbl, out, cxt, order, in_run, run_dist

    init = (tbl, out, jnp.uint32(0), jnp.int32(3), jnp.bool_(False),
            jnp.uint32(0))
    bound = max_len if steps is None else jnp.minimum(steps, max_len)
    carry = jax.lax.fori_loop(0, bound, body, init)
    return carry[1]


def _code_span_packed(inp, length, max_len: int, decode: bool, steps=None):
    """Packed-record variant for spans <= 32767 bytes.

    Same lpx.cpp semantics as _code_span_wide on a (4, 256, 3) int32
    table: word 0 = cxt (24 bits), word 1 = pos | hits << 16, word 2 =
    miss | thr << 16.  Every counter is bounded by the span length — pos
    and the match/miss counts by construction, thr because it only ever
    mixes toward a clamped distance (<= pos) or toward MaxThreshold — so
    with spans < 2^15 both packs stay positive int32 and unpack with
    plain shifts.  Slice 3 is the same write-scratch slot as the wide
    variant.  Per step: one fused 9-element gather, one 4-element
    scatter (the trailing row's pos/hits word never changes)."""
    assert max_len <= 0x7FFF
    tbl = jnp.zeros((_T_SLICES, 256, 3), jnp.int32).at[:3, :, 2].set(
        (LPX_MAX_THRESHOLD >> 1) << 16)
    out = jnp.zeros(max_len, jnp.uint8)
    g_t = jnp.asarray([1, 2, 0, 1, 2, 1, 2, 1, 2])
    s_w = jnp.asarray([0, 1, 2, 2])

    def body(i, carry):
        tbl, out, cxt, order, in_run, run_dist = carry
        active = i < length

        lp0 = (cxt & 0xFF).astype(jnp.int32)
        o = order
        t = o - 1
        lp = (cxt >> (o * 8)).astype(jnp.int32) & 0xFF
        ls = (cxt & ((jnp.uint32(1) << (o * 8)) - 1)).astype(jnp.int32)
        td = jnp.maximum(t - 1, 0)
        tu = jnp.minimum(t + 1, 2)
        # ONE fused gather of everything the step reads: run row (t,lp0)
        # w1+w2, primary row (t,lp) w0+w1+w2, trailing rows (t±1,lp) w1+w2
        g = tbl[jnp.stack([t, t, t, t, t, td, td, tu, tu]),
                jnp.stack([lp0, lp0, lp, lp, lp, lp, lp, lp, lp]),
                g_t]
        r0_pos, r0_hits, r0_thr = g[0] & 0xFFFF, g[0] >> 16, g[1] >> 16
        r_cxt = g[2]
        r_pos, r_hits = g[3] & 0xFFFF, g[3] >> 16
        r_miss, r_thr = g[4] & 0xFFFF, g[4] >> 16
        dn_hits, up_hits = g[5] >> 16, g[7] >> 16
        dn_miss, dn_thr = g[6] & 0xFFFF, g[6] >> 16
        up_miss, up_thr = g[8] & 0xFFFF, g[8] >> 16

        dist_new = jnp.uint32(i) - r0_pos.astype(jnp.uint32)
        start_run = (
            jnp.logical_not(in_run)
            & (r0_hits > r0_thr)
            & (dist_new < LPX_MAX_RECORD_SIZE)
        )
        coding = in_run | start_run
        dist = jnp.where(in_run, run_dist, dist_new).astype(jnp.int32)

        src = jnp.where(coding, i - dist, 0)
        ref_byte = (out[src] if decode else inp[src]).astype(jnp.uint8)
        cur = inp[i].astype(jnp.uint8)
        if decode:
            err = jnp.where(coding, cur, jnp.uint8(0))
            emitted = jnp.where(coding, ref_byte ^ cur, cur)
        else:
            err = jnp.where(coding, ref_byte ^ cur, jnp.uint8(0))
            emitted = jnp.where(coding, ref_byte ^ cur, cur)
        out = out.at[i].set(jnp.where(active, emitted, out[i]))
        orig_byte = emitted if decode else cur

        # ---- _update_table on the unpacked fields (identical arithmetic)
        distance = i - r_pos
        lower = jnp.int32(LPX_MIN_THRESHOLD)
        upper = jnp.where(
            r_hits < LPX_MAX_THRESHOLD,
            jnp.maximum(distance, lower),
            jnp.minimum(distance >> o, LPX_MAX_THRESHOLD >> o),
        )
        bound = jnp.where(
            distance <= lower, lower,
            jnp.where(distance > upper, upper, distance))

        gate = active & (i > o)
        match = gate & (r_cxt == ls)
        mismatch = gate & (r_cxt != ls)

        new_pos = jnp.where(match, i - o, r_pos)
        new_hits = jnp.where(match, r_hits + 1, r_hits)
        new_miss = jnp.where(match, 0, r_miss)
        new_hits = jnp.where(mismatch, r_hits >> 2, new_hits)
        new_miss = jnp.where(mismatch, r_miss + 1, new_miss)
        new_cxt = jnp.where(mismatch, ls, r_cxt)

        o_down = match & (new_hits > ((r_thr << o) << 3)) & (o > 1) & (o <= 3)
        o_up = mismatch & (new_miss > r_thr * r_thr * o) & (o >= 1) & (o < 3)
        new_order = jnp.where(o_down, o - 1, jnp.where(o_up, o + 1, o))

        tn = new_order - 1
        same = tn == t
        dn = tn < t
        h2 = jnp.where(same, new_hits, jnp.where(dn, dn_hits, up_hits))
        m2 = jnp.where(same, new_miss, jnp.where(dn, dn_miss, up_miss))
        th2 = jnp.where(same, r_thr, jnp.where(dn, dn_thr, up_thr))
        pre2_miss = jnp.where(dn, dn_miss, up_miss)
        thr_up = match & (h2 > (th2 << 1)) & (m2 == 0)
        thr_m = th2 + ((bound - th2) >> new_order)
        thr_up2 = mismatch & (m2 > th2)
        thr_mm = th2 + ((LPX_MAX_THRESHOLD - th2) >> (4 - new_order))
        new_thr = jnp.where(thr_up, thr_m, jnp.where(thr_up2, thr_mm, th2))

        w1a = new_pos | (new_hits << 16)
        w2a = new_miss | (jnp.where(same, new_thr, r_thr) << 16)
        w2b = pre2_miss | (new_thr << 16)
        tb = jnp.where(same, jnp.int32(_T_SLICES - 1), tn)
        tbl = tbl.at[jnp.stack([t, t, t, tb]),
                     jnp.stack([lp, lp, lp, lp]),
                     s_w].set(jnp.stack([new_cxt, w1a, w2a, w2b]))

        order = new_order  # == order when inactive (gates are off)
        cxt = jnp.where(
            active, (cxt << 8) | orig_byte.astype(jnp.uint32), cxt
        )
        next_in_run = coding & (err == 0)
        in_run = jnp.where(active, next_in_run, in_run)
        run_dist = jnp.where(active & coding, dist.astype(jnp.uint32),
                             run_dist)
        return tbl, out, cxt, order, in_run, run_dist

    init = (tbl, out, jnp.uint32(0), jnp.int32(3), jnp.bool_(False),
            jnp.uint32(0))
    bound = max_len if steps is None else jnp.minimum(steps, max_len)
    carry = jax.lax.fori_loop(0, bound, body, init)
    return carry[1]


@partial(jax.jit, static_argnames=("max_len", "decode"))
def _code_spans(spans, lengths, max_len: int, decode: bool):
    return jax.vmap(lambda s, ln: _code_span(s, ln, max_len, decode))(
        spans, lengths
    )


def _lpx_device(data: np.ndarray, decode: bool, nspans: int = 4) -> np.ndarray:
    from ..stages.lpx import _split_spans

    data = np.asarray(data, dtype=np.uint8)
    spans = _split_spans(data.size, nspans)
    if not spans:
        return np.zeros(0, dtype=np.uint8)
    max_len = max(ln for _, ln in spans)
    padded = np.zeros((len(spans), max_len), dtype=np.uint8)
    lengths = np.zeros(len(spans), dtype=np.int32)
    for k, (start, ln) in enumerate(spans):
        padded[k, :ln] = data[start : start + ln]
        lengths[k] = ln
    out = _code_spans(
        jnp.asarray(padded), jnp.asarray(lengths), max_len, decode
    )
    out = np.asarray(jax.device_get(out))
    res = np.empty(data.size, dtype=np.uint8)
    for k, (start, ln) in enumerate(spans):
        res[start : start + ln] = out[k, :ln]
    return res


def lpx_encode_device(data: np.ndarray, spans: int = 4) -> np.ndarray:
    return _lpx_device(data, decode=False, nspans=spans)


def lpx_decode_device(data: np.ndarray, spans: int = 4) -> np.ndarray:
    return _lpx_device(data, decode=True, nspans=spans)
