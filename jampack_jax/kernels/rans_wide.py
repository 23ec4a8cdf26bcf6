"""Wide (lane-vectorized) rANS decoder and encode model pass in plain XLA.

decode_chunk_syms (rans_decode.py) decodes one chain with proper scalar
control flow; under jax.vmap its lax.cond turns into a select, so the
expensive quasi rescale body runs every step for every lane.  This kernel
instead carries the lane dimension explicitly: all model banks get a
leading L axis and the quasi rescale hides behind ONE scalar predicate
("does any active lane rescale this step") so its cost is paid only on
the steps that need it — early in a chunk while the update period is
still doubling (model.cpp:160-204), then once per 64K quasi symbols per
lane.  It is the plain reference the Pallas kernels (rans_pallas.py) are
checked against, and the entropy stage wherever those do not run.

Layout:

  * ALL nine models (1 exponent + 2 adaptive-mantissa + 6 quasi, widths
    8/2/2/4/8/16/32/64/129) live in ONE (L, 256) uint16 bank holding only
    the INTERIOR cum entries (cum[0] = 0 and cum[alpha] = 2^16 are
    constants) — 256 = sum of interior widths exactly;
  * the per-model (symbol, low, freq) lookups are segment sums over that
    bank, computed by ONE contraction per step: two f32 planes (le*d for
    low; onehot*d + le*2^17 packing freq and the symbol index into one
    integer-exact f32 word < 2^24) against a static (256, 9)
    segment-indicator matrix;
  * no per-step gathers or scatters beyond the per-lane payload-window
    fetch (inherent to the format): everything data-dependent is a
    masked elementwise select;
  * the rescale's log search is a fori_loop (unrolled it dominated
    compile time).

Bit-exact with rans_common / stages.models: int32 mixing shifts, the
unsigned rescale stretch, truncating division, byte-renorm order.  The
f32 plane sums are exact: every addend is an integer and every partial
sum is <= 2^24 (low <= 65535; freq <= 65535 packed under index*2^17 with
index <= 128, and the index-128 case has an all-false onehot, landing on
exactly 2^24) — provided the contraction runs at HIGHEST precision (a
TF32 or bf16 pass would round them).  Lanes of unequal length freeze (no
byte consumption, no model updates) once exhausted so their final-state
invariant still holds.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..format.constants import (
    MODEL_SWITCH_THRESHOLD,
    PROB_BITS,
    PROB_SCALE,
    RANS_BYTE_L,
)
from ..format.tables import EXPONENT
from .rans_common import (
    EXP_INIT,
    EXP_MIX,
    MANT_ADAPT_INIT,
    MANT_ADAPT_MIX,
    NQ,
    QALPHAS,
    QUASI_INIT_CUM,
    RATE,
    UPDATE_RATE,
)

_NSW = MODEL_SWITCH_THRESHOLD  # 2 adaptive mantissa models

# ---------------------------------------------------------------------------
# Static bank layout: models in order [exp, ma0, ma1, q0..q5]; each segment
# holds the interior cum entries cum[1..alpha-1] of its model.

_ALPHAS = [8, 2, 2] + [int(a) for a in QALPHAS]      # 9 model alphabets
_WIDTHS = [a - 1 for a in _ALPHAS]                    # interior widths
_BOFF = np.concatenate([[0], np.cumsum(_WIDTHS)])     # (10,) segment offsets
_BCOLS = int(_BOFF[-1])                               # == 256
assert _BCOLS == 256

_SEG_ID = np.repeat(np.arange(9), _WIDTHS)            # (256,) col -> model
_SEG_START = np.zeros(_BCOLS, bool)
_SEG_START[_BOFF[:-1]] = True
_IS_RNG1 = _SEG_ID == 0                               # exp model cols
_SEG_MAT = np.zeros((_BCOLS, 9), np.float32)
_SEG_MAT[np.arange(_BCOLS), _SEG_ID] = 1.0

# quasi count space: per-model widths = alphas, total 253
_QALPHA_L = [int(a) for a in QALPHAS]
_QOFF = np.concatenate([[0], np.cumsum(_QALPHA_L)])
_QCOLS = int(_QOFF[-1])

_PACK = 1 << 17  # symbol-index packing stride in the freq plane

# per-model alphabet sizes, for the encode-side known-symbol lookups
_ALPHA_BY_MODEL = list(_ALPHAS)


def _init_bank_row() -> np.ndarray:
    """(256,) uint16 initial interior-cum bank (ans.cpp:136-140 resets)."""
    parts = [np.asarray(EXP_INIT[1:8])]
    for k in range(_NSW):
        parts.append(np.asarray(MANT_ADAPT_INIT[k][1:2]))
    for k in range(NQ):
        a = _QALPHA_L[k]
        parts.append(np.asarray(QUASI_INIT_CUM[k, 1:a]))
    row = np.concatenate(parts)
    assert row.shape == (_BCOLS,) and row.min() > 0 and row.max() < PROB_SCALE
    return row.astype(np.uint16)


_BANK_INIT = _init_bank_row()


def _quasi_rescale_all(bank, qf, q_seen, q_exp, pred, qi):
    """Rescale the active quasi model of every lane with `pred` set
    (model.cpp:160-204, unsigned semantics); returns the updated
    (bank, qf, q_seen, q_exp).  Callers run this behind a scalar
    jnp.any(pred) lax.cond so the cost is paid only on steps that
    actually rescale."""
    L = bank.shape[0]
    nq_col = jnp.arange(NQ)[None, :]
    new_bank_segs, new_qf_segs = [], []
    for k in range(NQ):
        alpha = _QALPHA_L[k]
        c0 = int(_QOFF[k])
        qfk = qf[:, c0:c0 + alpha]                  # (L, alpha)
        total = jnp.sum(qfk, axis=1)
        # smallest log with (total>>log)+alpha <= 2^16; fori keeps the
        # traced body small
        logv = jax.lax.fori_loop(
            0, 21,
            lambda _, lv: lv
            + (((total >> lv) + alpha) > PROB_SCALE).astype(jnp.int32),
            jnp.zeros_like(total),
        )
        f = (qfk >> logv[:, None]) + 1
        t2 = jnp.sum(f, axis=1)
        # model.cpp:183 is UNSIGNED; product < 2^32: exact
        prod = f.astype(jnp.uint32) << PROB_BITS
        q = (prod // t2[:, None].astype(jnp.uint32)).astype(jnp.int32)
        fix = PROB_SCALE - jnp.sum(q, axis=1)
        q = q.at[:, 0].add(fix)
        cum = jnp.cumsum(q[:, :alpha - 1], axis=1)  # interior only
        rowm = (pred & (qi == k))[:, None]
        b0 = int(_BOFF[3 + k])
        old = bank[:, b0:b0 + alpha - 1]
        new_bank_segs.append(
            jnp.where(rowm, cum.astype(jnp.uint16), old))
        new_qf_segs.append(jnp.where(rowm, 0, qfk))
    nb = jnp.concatenate(
        [bank[:, :int(_BOFF[3])]] + new_bank_segs, axis=1)
    nqf = jnp.concatenate(new_qf_segs, axis=1)
    resc_hit = (nq_col == qi[:, None]) & pred[:, None]  # (L, NQ)
    q_seen = jnp.where(resc_hit, 0, q_seen)
    new_exp = jnp.where(q_exp < UPDATE_RATE, q_exp << 1, UPDATE_RATE)
    q_exp = jnp.where(resc_hit, new_exp, q_exp)
    return nb, nqf, q_seen, q_exp


@partial(jax.jit, static_argnames=("max_rlen", "groups"))
def decode_lanes_wide(buf: jnp.ndarray, starts: jnp.ndarray,
                      rlens: jnp.ndarray, max_rlen: int, groups: int = 0):
    """Decode L independent chains in lockstep.

    buf: uint8 stream; starts/rlens: (L,) per-chain payload offsets and
    symbol counts.  Returns (syms (L, max_rlen) uint16, ok (L,) bool).

    With `groups` = G > 0 (G must divide L), the symbols are emitted
    directly in round-robin-undealt layout instead: (G, max_rlen * L//G)
    uint16 with chunk-row g's symbol j at column j — i.e. step i writes
    the (G, L//G) slab at columns [i*L//G, (i+1)*L//G).  This makes the
    consumer's per-chunk "lane undeal" a no-op: the in-loop slab write
    costs nothing over the (L,) column write, where a reshape+transpose
    undeal is one more pass over every symbol."""
    L = starts.shape[0]
    buf = buf.astype(jnp.uint32)
    mask16 = jnp.uint32(PROB_SCALE - 1)
    # 4-byte little-endian lookahead window at every position: the two
    # renorms of a step consume <= 4 sequential bytes total, so ONE window
    # gather per step replaces up to four byte gathers (gathers are the
    # per-step random-access cost; the window build is elementwise)
    bp = jnp.pad(buf, (0, 3))
    win = bp[:-3] | (bp[1:-2] << 8) | (bp[2:-1] << 16) | (bp[3:] << 24)

    def read32(p):
        return buf[p] | (buf[p + 1] << 8) | (buf[p + 2] << 16) | (buf[p + 3] << 24)

    R = jnp.stack([read32(starts + 4 * i) for i in range(4)], axis=1)  # (L,4)
    R = R.astype(jnp.uint32)
    ptr = starts + 16

    bank = jnp.broadcast_to(jnp.asarray(_BANK_INIT), (L, _BCOLS))
    qf = jnp.zeros((L, _QCOLS), jnp.int32)
    q_seen = jnp.zeros((L, NQ), dtype=jnp.int32)
    q_exp = jnp.full((L, NQ), 8, dtype=jnp.int32)

    exp_mix_i = jnp.asarray(EXP_MIX[:, 1:8])      # (8, 7) interior targets
    ma_mix_i = jnp.asarray(MANT_ADAPT_MIX[:, :, 1])  # (2, 2) interior scalar
    seg_mat = jnp.asarray(_SEG_MAT)
    seg_start = jnp.asarray(_SEG_START)
    is_rng1 = jnp.asarray(_IS_RNG1)
    if groups:
        assert L % groups == 0
        syms = jnp.zeros((groups, max_rlen, L // groups), dtype=jnp.uint16)
    else:
        syms = jnp.zeros((L, max_rlen), dtype=jnp.uint16)
    nq_col = jnp.arange(NQ)[None, :]

    def renorm(x, w, kb, active):
        # two refills always suffice: pre-advance x >= 2^23 and freq >= 1
        # give post-advance x >= 2^7, and 7 + 2*8 = 23 bits renormalizes.
        # Bytes come from the step's window w at local byte offset kb (< 4
        # over both renorms of a step by the bound above).
        for _ in range(2):
            need = active & (x < RANS_BYTE_L)
            byte = (w >> (kb << 3).astype(jnp.uint32)) & jnp.uint32(0xFF)
            x = jnp.where(need, (x << 8) | byte, x)
            kb = jnp.where(need, kb + 1, kb)
        return x, kb

    def advance(x, lo, fq):
        return (
            fq.astype(jnp.uint32) * (x >> PROB_BITS)
            + (x & mask16)
            - lo.astype(jnp.uint32)
        )

    def body(i, carry):
        (R, ptr, bank, qf, q_seen, q_exp, syms) = carry
        active = i < rlens
        w = win[ptr]  # the step's single payload gather
        kb = jnp.zeros_like(ptr)

        # ---- both comparands are known at step start: the exponent symbol
        # uses state R0, the mantissa symbol uses (pre-rotation) state R1
        rng1 = (R[:, 0] & mask16).astype(jnp.uint16)
        rng2 = (R[:, 1] & mask16).astype(jnp.uint16)
        rc = jnp.where(is_rng1[None, :], rng1[:, None], rng2[:, None])
        le = bank <= rc                                     # (L, 256)
        # within-segment diffs: d[j] = cum[j] - cum[j-1] (= freq[j-1] >= 1)
        bshift = jnp.concatenate(
            [jnp.zeros((L, 1), jnp.uint16), bank[:, :-1]], axis=1)
        d = (bank - jnp.where(seg_start[None, :], jnp.uint16(0), bshift))
        # onehot of cum[m+1] within the segment: le shifted right one col
        # (True at segment starts) AND NOT le
        le1 = jnp.concatenate(
            [jnp.ones((L, 1), bool), le[:, :-1]], axis=1)
        le1 = jnp.where(seg_start[None, :], True, le1)
        oh_hi = le1 & ~le

        df = d.astype(jnp.float32)
        lef = le.astype(jnp.float32)
        p_lo = lef * df
        p_mf = oh_hi.astype(jnp.float32) * df + lef * jnp.float32(_PACK)
        # ONE contraction: (L, 2, 256) x (256, 9) -> per-model
        # (low, packed index/freq) sums; every addend and partial sum is an
        # integer <= 2^24, so f32 accumulation is exact
        planes = jnp.stack([p_lo, p_mf], axis=1)
        # HIGHEST precision: a default-precision f32 product may run in
        # TF32 (GPU) or one bf16 pass, neither exact for 17-bit integer
        # operands
        sums = jax.lax.dot_general(
            planes, seg_mat, (((2,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32)          # (L, 2, 9)
        lo_all = sums[:, 0, :].astype(jnp.int32)
        t_all = sums[:, 1, :].astype(jnp.int32)
        m_all = t_all >> 17
        fqp = t_all & jnp.int32(_PACK - 1)
        # fqp == 0 <=> m == alpha-1 (freqs are >= 1): freq = 2^16 - low
        fq_all = jnp.where(fqp == 0, PROB_SCALE - lo_all, fqp)

        # ---- exponent symbol (model 0, rng1)
        e = m_all[:, 0]
        x2 = advance(R[:, 0], lo_all[:, 0], fq_all[:, 0])
        x2, kb = renorm(x2, w, kb, active)
        R = jnp.concatenate(
            [R[:, 1:], jnp.where(active, x2, R[:, 0])[:, None]], axis=1
        )

        # ---- mantissa symbol: select the active model's (m, lo, fq)
        is_adaptive = e < _NSW
        ei = jnp.clip(e, 0, _NSW - 1)
        qi = jnp.clip(e - _NSW, 0, NQ - 1)
        midx = jnp.where(is_adaptive, 1 + ei, 3 + qi)
        m = m_all[:, 1]
        lo = lo_all[:, 1]
        fq = fq_all[:, 1]
        for k in range(2, 9):
            sel = midx == k
            m = jnp.where(sel, m_all[:, k], m)
            lo = jnp.where(sel, lo_all[:, k], lo)
            fq = jnp.where(sel, fq_all[:, k], fq)
        x2 = advance(R[:, 0], lo, fq)
        x2, kb = renorm(x2, w, kb, active)
        ptr = ptr + kb
        R = jnp.concatenate(
            [R[:, 1:], jnp.where(active, x2, R[:, 0])[:, None]], axis=1
        )

        # ---- adaptive updates on the bank (int32 mixing arithmetic on the
        # uint16 interior entries; results stay in (0, 2^16))
        bi = bank.astype(jnp.int32)
        # exponent model (cols 0..6): 8-way select of the interior target
        mix_e = jnp.broadcast_to(exp_mix_i[0], (L, 7))
        for kk in range(1, 8):
            mix_e = jnp.where((e == kk)[:, None], exp_mix_i[kk], mix_e)
        upd_e = bi[:, :7] + ((mix_e - bi[:, :7]) >> RATE)
        # adaptive mantissa (cols 7, 8): single interior entry per model;
        # 4-way select of the scalar target
        m01 = jnp.clip(m, 0, 1)
        mix_a = jnp.full((L,), int(MANT_ADAPT_MIX[0, 0, 1]), jnp.int32)
        for ii in range(2):
            for jj in range(2):
                if ii == 0 and jj == 0:
                    continue
                mix_a = jnp.where((ei == ii) & (m01 == jj),
                                  ma_mix_i[ii, jj], mix_a)
        a_upd = active & is_adaptive
        ma_cols = bi[:, 7:9]
        upd_a = ma_cols + ((mix_a[:, None] - ma_cols) >> RATE)
        ma_mask = jnp.stack([a_upd & (ei == 0), a_upd & (ei == 1)], axis=1)
        new_head = jnp.concatenate(
            [jnp.where(active[:, None], upd_e, bi[:, :7]),
             jnp.where(ma_mask, upd_a, ma_cols)], axis=1)
        bank = jnp.concatenate(
            [new_head.astype(jnp.uint16), bank[:, 9:]], axis=1)

        # ---- quasi count/seen updates.  The count one-hot in symbol space
        # is derived from le: onehot[j] = le_ext[j] & ~le_ext[j+1] with
        # le_ext = [True, le_segment, False] — all static slices/concat.
        q_upd = active & jnp.logical_not(is_adaptive)
        qsel_cols, oh_cnt_parts = [], []
        for k in range(NQ):
            a = _QALPHA_L[k]
            b0 = int(_BOFF[3 + k])
            seg = le[:, b0:b0 + a - 1]
            ext_l = jnp.concatenate([jnp.ones((L, 1), bool), seg], axis=1)
            ext_r = jnp.concatenate([seg, jnp.zeros((L, 1), bool)], axis=1)
            oh_cnt_parts.append(ext_l & ~ext_r)
            qsel_cols.append(jnp.broadcast_to(
                (q_upd & (qi == k))[:, None], (L, a)))
        oh_cnt = jnp.concatenate(oh_cnt_parts, axis=1)       # (L, 253)
        qsel = jnp.concatenate(qsel_cols, axis=1)            # (L, 253)
        qf = qf + jnp.where(oh_cnt & qsel, jnp.int32(PROB_BITS), 0)
        q_hit = (nq_col == qi[:, None]) & q_upd[:, None]     # (L, NQ)
        q_seen = q_seen + q_hit.astype(jnp.int32)
        seen_row = jnp.sum(jnp.where(q_hit, q_seen, 0), axis=1)
        exp_row = jnp.sum(jnp.where(q_hit, q_exp, 0), axis=1)

        # ---- quasi rescale behind ONE scalar predicate
        pred = q_upd & (seen_row > exp_row)
        bank, qf, q_seen, q_exp = jax.lax.cond(
            jnp.any(pred),
            lambda a: _quasi_rescale_all(*a, pred, qi), lambda a: a,
            (bank, qf, q_seen, q_exp),
        )

        base = jnp.zeros_like(e)  # 8-way select of EXPONENT[e]
        for kk in range(1, 8):
            base = jnp.where(e == kk, jnp.int32(int(EXPONENT[kk])), base)
        sym = (base + m).astype(jnp.uint16)
        # each column is written exactly once and the buffer starts zeroed,
        # so inactive lanes store 0 — no read of the old value needed
        sym = jnp.where(active, sym, 0)
        if groups:
            syms = syms.at[:, i, :].set(sym.reshape(groups, L // groups))
        else:
            syms = syms.at[:, i].set(sym)
        return (R, ptr, bank, qf, q_seen, q_exp, syms)

    init = (R, ptr, bank, qf, q_seen, q_exp, syms)
    # traced bound: max_rlen is only the (bucketed) output width, so shape
    # padding costs zero loop steps and compile variants stay bounded
    steps = jnp.minimum(jnp.maximum(jnp.max(rlens), 0), max_rlen)
    out = jax.lax.fori_loop(0, steps, body, init)
    R, syms = out[0], out[-1]
    if groups:
        syms = syms.reshape(groups, max_rlen * (L // groups))
    # rlens < 0 marks batch-padding lanes (no chain there at all)
    ok = jnp.all(R == jnp.uint32(RANS_BYTE_L), axis=1) | (rlens < 0)
    return syms, ok


# ---------------------------------------------------------------------------
# Wide (lane-vectorized) forward MODEL pass — the encode mirror.


def model_pairs_wide(chains: jnp.ndarray, rlens: jnp.ndarray,
                     max_rlen: int):
    """Forward model pass for L chains in lockstep (ans.cpp:152-187):
    2 (low, freq) ops per symbol through the same (L, 256) uint16
    interior-cum bank as the decoder.  The encode direction KNOWS each
    step's symbol, so the per-model lookups are one-hot column reads of
    the bank (cum[m], cum[m+1]) — no range search, no per-lane gathers;
    the exponent class itself comes from 7 boundary compares instead of a
    LOG[] table gather.  Updates (CDF mixing, quasi counts, the rescale
    behind one scalar predicate) are shared with the decoder.

    chains: (L, max_rlen) uint16; rlens: (L,) actual lengths.
    Returns (lows (L, 2*max_rlen) u16, fqs (L, 2*max_rlen) u16, ok (L,)).
    ok is False where a zero-frequency op was hit (wrap-regime chunk,
    model.cpp:183 failure parity — not encodable in ref-compat mode).
    """
    L = chains.shape[0]
    bank = jnp.broadcast_to(jnp.asarray(_BANK_INIT), (L, _BCOLS))
    qf = jnp.zeros((L, _QCOLS), jnp.int32)
    q_seen = jnp.zeros((L, NQ), dtype=jnp.int32)
    q_exp = jnp.full((L, NQ), 8, dtype=jnp.int32)
    lows = jnp.zeros((L, 2 * max_rlen), jnp.uint16)
    fqs = jnp.zeros((L, 2 * max_rlen), jnp.uint16)

    exp_mix_i = jnp.asarray(EXP_MIX[:, 1:8])      # (8, 7) interior targets
    ma_mix_i = jnp.asarray(MANT_ADAPT_MIX[:, :, 1])  # (2, 2) interior scalar
    nq_col = jnp.arange(NQ)[None, :]
    exp_bounds = [int(EXPONENT[k]) for k in range(1, 8)]
    alphas = jnp.asarray(_ALPHA_BY_MODEL, dtype=jnp.int32)
    seg_start = jnp.asarray(_SEG_START)
    seg_id = jnp.asarray(_SEG_ID.astype(np.int32))[None, :]      # (1, 256)
    col_within = jnp.asarray(
        (np.arange(_BCOLS) - _BOFF[_SEG_ID]).astype(np.int32))[None, :]

    def body(i, carry):
        bank, qf, q_seen, q_exp, lows, fqs, ok = carry
        active = i < rlens
        sym = chains[:, i].astype(jnp.int32)
        # exponent class: 7 boundary compares (tables.py EXPONENT)
        e = jnp.zeros(L, jnp.int32)
        for b in exp_bounds:
            e = e + (sym >= b)
        base = jnp.zeros(L, jnp.int32)
        for kk in range(1, 8):
            base = jnp.where(e == kk, jnp.int32(int(EXPONENT[kk])), base)
        m = sym - base

        is_adaptive = e < _NSW
        ei = jnp.clip(e, 0, _NSW - 1)
        qi = jnp.clip(e - _NSW, 0, NQ - 1)
        midx = jnp.where(is_adaptive, 1 + ei, 3 + qi)
        malpha = alphas[midx]

        # ---- both ops' (low, freq) from two shared masks (the symbol is
        # KNOWN, so no bank compares): lt = interior cols below the symbol
        # index (lo = their freq sum), oh = the symbol's own interior diff
        # (its freq).  The exp op lives in segment 0 and the mantissa op in
        # segment midx >= 1 — disjoint — so a seg0 split separates the two
        # ops' sums: four masked integer sums.
        bshift = jnp.concatenate(
            [jnp.zeros((L, 1), jnp.uint16), bank[:, :-1]], axis=1)
        d = (bank - jnp.where(seg_start[None, :], jnp.uint16(0), bshift))
        sel_idx = jnp.where(seg_id == 0, e[:, None], m[:, None])
        in_seg = (seg_id == 0) | (seg_id == midx[:, None])
        lt = in_seg & (col_within < sel_idx)
        oh = in_seg & (col_within == sel_idx)
        is0 = seg_id == 0
        di = d.astype(jnp.int32)
        lo_e = jnp.sum(jnp.where(lt & is0, di, 0), axis=1)
        lo_m = jnp.sum(jnp.where(lt & ~is0, di, 0), axis=1)
        fqp_e = jnp.sum(jnp.where(oh & is0, di, 0), axis=1)
        fqp_m = jnp.sum(jnp.where(oh & ~is0, di, 0), axis=1)
        # the LAST symbol of a model has no interior diff: freq = 2^16-low
        # (always >= 1 since interior cums stay < 2^16); anywhere else a
        # zero sum means a zero-frequency op -> failure parity (refuse to
        # emit an undecodable chunk)
        last_e = e == 7
        last_m = m == malpha - 1
        fq_e = jnp.where(last_e, PROB_SCALE - lo_e, fqp_e)
        fq_m = jnp.where(last_m, PROB_SCALE - lo_m, fqp_m)
        ok = ok & ((last_e | (fqp_e > 0)) & (last_m | (fqp_m > 0))
                   | ~active)
        pair_lo = jnp.stack([lo_e, lo_m], axis=1).astype(jnp.uint16)
        pair_fq = jnp.stack([fq_e, fq_m], axis=1).astype(jnp.uint16)
        lows = jax.lax.dynamic_update_slice(lows, pair_lo, (0, 2 * i))
        fqs = jax.lax.dynamic_update_slice(fqs, pair_fq, (0, 2 * i))

        # ---- adaptive updates (identical arithmetic to the decoder)
        bi = bank.astype(jnp.int32)
        mix_e = jnp.broadcast_to(exp_mix_i[0], (L, 7))
        for kk in range(1, 8):
            mix_e = jnp.where((e == kk)[:, None], exp_mix_i[kk], mix_e)
        upd_e = bi[:, :7] + ((mix_e - bi[:, :7]) >> RATE)
        m01 = jnp.clip(m, 0, 1)
        mix_a = jnp.full((L,), int(MANT_ADAPT_MIX[0, 0, 1]), jnp.int32)
        for ii in range(2):
            for jj in range(2):
                if ii == 0 and jj == 0:
                    continue
                mix_a = jnp.where((ei == ii) & (m01 == jj),
                                  ma_mix_i[ii, jj], mix_a)
        a_upd = active & is_adaptive
        ma_cols = bi[:, 7:9]
        upd_a = ma_cols + ((mix_a[:, None] - ma_cols) >> RATE)
        ma_mask = jnp.stack([a_upd & (ei == 0), a_upd & (ei == 1)], axis=1)
        new_head = jnp.concatenate(
            [jnp.where(active[:, None], upd_e, bi[:, :7]),
             jnp.where(ma_mask, upd_a, ma_cols)], axis=1)
        bank = jnp.concatenate(
            [new_head.astype(jnp.uint16), bank[:, 9:]], axis=1)

        # ---- quasi count/seen updates: the count one-hot comes straight
        # from the known symbol index
        q_upd = active & jnp.logical_not(is_adaptive)
        oh_parts = []
        for k in range(NQ):
            a = _QALPHA_L[k]
            ck = jnp.arange(a, dtype=jnp.int32)[None, :]
            oh_parts.append((ck == m[:, None]) & (q_upd & (qi == k))[:, None])
        oh = jnp.concatenate(oh_parts, axis=1)               # (L, 253)
        qf = qf + jnp.where(oh, jnp.int32(PROB_BITS), 0)
        q_hit = (nq_col == qi[:, None]) & q_upd[:, None]     # (L, NQ)
        q_seen = q_seen + q_hit.astype(jnp.int32)
        seen_row = jnp.sum(jnp.where(q_hit, q_seen, 0), axis=1)
        exp_row = jnp.sum(jnp.where(q_hit, q_exp, 0), axis=1)

        pred = q_upd & (seen_row > exp_row)
        bank, qf, q_seen, q_exp = jax.lax.cond(
            jnp.any(pred),
            lambda a: _quasi_rescale_all(*a, pred, qi), lambda a: a,
            (bank, qf, q_seen, q_exp),
        )
        return bank, qf, q_seen, q_exp, lows, fqs, ok

    steps = jnp.minimum(jnp.maximum(jnp.max(rlens), 0), max_rlen)
    out = jax.lax.fori_loop(
        0, steps, body,
        (bank, qf, q_seen, q_exp, lows, fqs, jnp.ones(L, bool)))
    return out[4], out[5], out[6]
