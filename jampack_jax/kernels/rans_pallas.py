"""Wide rANS decode and encode model pass as Pallas kernels for NVIDIA
GPUs (the Triton route).

decode_lanes_wide (rans_wide.py) is the plain form: an XLA fori_loop whose
body lowers to many small fusions, so every symbol step makes a round trip
through device memory for the whole (L, 256) model bank.  Here one program
owns a block of LB chains and runs the WHOLE symbol loop inside the
kernel: the model state and the rANS registers stay on chip for the
chains' lifetime, the payload is read with masked per-lane byte gathers,
and only the symbols are written out.  model_pairs_wide_pallas is the
known-symbol mirror for the encoder's model pass, with the same state and
update rules.

Model state per lane, one tile per model so no slicing is ever needed:
the exponent model (alphabet 8) keeps its 7 interior cum entries in an
(LB, 8) tile, the two adaptive mantissa models (alphabet 2) one entry
each, and the six quasi models (alphabets 4..129) their interior cums and
symbol counts in (LB, W) tiles, W the next power of two.  Cums are
nondecreasing within a model (mixing toward nondecreasing targets and the
quasi rescale both keep the order), so a symbol's (low, high) pair is
(largest cum <= state, smallest cum > state) and its index is the count
of cums <= state.

Bit-exact with rans_wide: int32 mixing shifts, the unsigned rescale
division, byte-renorm order, frozen exhausted lanes, clamped payload
reads past the end.  Reference semantics: ans.cpp:152-208,
model.cpp:60-204.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..format.constants import PROB_BITS, PROB_SCALE, RANS_BYTE_L
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

LB = 16          # chains per program
# warps per program, from timings on an H100: the decode step is latency-
# bound and runs 5.8x faster in one warp than in four, whose reductions
# cross warps; the model pass (no payload reads, no lookups) runs 1.6x
# faster in four
_DECODE_WARPS = 1
_PAIRS_WARPS = 4
_QA = [int(a) for a in QALPHAS]                   # quasi alphabets
_QW = [1 << (a - 1).bit_length() for a in _QA]    # their tile widths
_EXP_BASE = [int(EXPONENT[k]) for k in range(8)]
_MIX_HI = PROB_SCALE - 8                          # exp mix targets above e
# adaptive-mantissa interior mix target by symbol (the same for both)
_MA_MIX = [int(MANT_ADAPT_MIX[0, j, 1]) for j in range(2)]
assert all(int(MANT_ADAPT_MIX[i, j, 1]) == _MA_MIX[j]
           for i in range(2) for j in range(2))
# exponent mix target for interior cum t (1..7) given symbol e: t if t <= e
assert all(int(EXP_MIX[e, t]) == (t if t <= e else _MIX_HI + t)
           for e in range(8) for t in range(1, 8))
assert PROB_BITS == 16


def _init_table() -> np.ndarray:
    """(8, 256) int32 initial interior cums: row 0 the exponent model,
    row 1 the two adaptive mantissa models, rows 2..7 the quasi models."""
    t = np.zeros((8, 256), np.int32)
    t[0, :7] = np.asarray(EXP_INIT)[1:8]
    t[1, 0] = int(MANT_ADAPT_INIT[0][1])
    t[1, 1] = int(MANT_ADAPT_INIT[1][1])
    for k in range(NQ):
        t[2 + k, :_QA[k] - 1] = np.asarray(QUASI_INIT_CUM[k, 1:_QA[k]])
    return t


_INIT = _init_table()


def _cols(w):
    return jax.lax.broadcasted_iota(jnp.int32, (1, w), 1)


def _select(idx, values):
    """values[idx] for a per-lane index into a short Python list."""
    out = values[0]
    for k in range(1, len(values)):
        out = jnp.where(idx == k, values[k], out)
    return out


def _init_state(init_ref):
    be = jnp.broadcast_to(plgpu.load(init_ref.at[0, pl.ds(0, 8)])[None, :],
                          (LB, 8))
    ma = [jnp.full((LB,), int(_INIT[1, a]), jnp.int32) for a in range(2)]
    bq = [jnp.broadcast_to(
        plgpu.load(init_ref.at[2 + k, pl.ds(0, _QW[k])])[None, :],
        (LB, _QW[k])) for k in range(NQ)]
    qf = [jnp.zeros((LB, _QW[k]), jnp.int32) for k in range(NQ)]
    seen = [jnp.zeros((LB,), jnp.int32) for _ in range(NQ)]
    qexp = [jnp.full((LB,), 8, jnp.int32) for _ in range(NQ)]
    return be, ma, bq, qf, seen, qexp


def _rescale(k, pred, bq, qf, seen, qexp):
    """Quasi rescale of model k on the lanes in `pred`
    (model.cpp:160-204, unsigned division)."""
    alpha, w = _QA[k], _QW[k]
    col = _cols(w)
    total = jnp.sum(qf, axis=1)
    logv = jnp.zeros((LB,), jnp.int32)
    for _ in range(21):  # smallest log with (total >> log) + alpha <= 2^16
        logv = logv + jnp.where(((total >> logv) + alpha) > PROB_SCALE, 1, 0)
    f = jnp.where(col < alpha, (qf >> logv[:, None]) + 1, 0)
    t2 = jnp.sum(f, axis=1)
    q = ((f.astype(jnp.uint32) << PROB_BITS)
         // t2.astype(jnp.uint32)[:, None]).astype(jnp.int32)
    fix = PROB_SCALE - jnp.sum(q, axis=1)
    q = jnp.where(col == 0, q + fix[:, None], q)
    cum = jnp.cumsum(q, axis=1) & 0xFFFF
    p2 = pred[:, None]
    bq = jnp.where(p2 & (col < alpha - 1), cum, bq)
    qf = jnp.where(p2, 0, qf)
    seen = jnp.where(pred, 0, seen)
    qexp = jnp.where(pred, jnp.where(qexp < UPDATE_RATE, qexp << 1,
                                     UPDATE_RATE), qexp)
    return bq, qf, seen, qexp


def _update(state, active, e, m):
    """Adaptive CDF mixing, quasi counts and the quasi rescale after the
    step's (exponent e, mantissa m) pair — shared verbatim by the decoder
    and the encoder's model pass."""
    be, ma, bq, qf, seen, qexp = state
    is_adaptive = e < 2
    ei = jnp.minimum(e, 1)
    qi = jnp.maximum(e - 2, 0)

    # exponent model: interior cum t = col + 1 moves toward t (t <= e) or
    # 2^16 - 8 + t, by >> RATE in int32
    t = _cols(8) + 1
    mix_e = jnp.where(t <= e[:, None], t, _MIX_HI + t)
    upd = active[:, None] & (t < 8)
    be = jnp.where(upd, be + ((mix_e - be) >> RATE), be)

    # adaptive mantissa models
    mix_a = jnp.where(m == 0, _MA_MIX[0], _MA_MIX[1])
    ma = [jnp.where(active & is_adaptive & (ei == a),
                    ma[a] + ((mix_a - ma[a]) >> RATE), ma[a])
          for a in range(2)]

    # quasi models: count the symbol, rescale behind one branch per model
    q_upd = active & jnp.logical_not(is_adaptive)
    bq, qf, seen, qexp = list(bq), list(qf), list(seen), list(qexp)
    for k in range(NQ):
        hit = q_upd & (qi == k)
        col = _cols(_QW[k])
        qf[k] = qf[k] + jnp.where(
            hit[:, None] & (col == m[:, None]) & (col < _QA[k]), PROB_BITS, 0)
        seen[k] = seen[k] + jnp.where(hit, 1, 0)
        pred = hit & (seen[k] > qexp[k])
        bq[k], qf[k], seen[k], qexp[k] = jax.lax.cond(
            jnp.max(jnp.where(pred, 1, 0)) > 0,
            partial(_rescale, k, pred), lambda *a: a,
            bq[k], qf[k], seen[k], qexp[k])
    return be, ma, bq, qf, seen, qexp


def _lookup(c, le, valid):
    """(index, low, high) of the symbol whose range holds the state, from
    a tile of nondecreasing interior cums and its `cum <= state` mask."""
    m = jnp.sum(jnp.where(le, 1, 0), axis=1)
    lo = jnp.max(jnp.where(le, c, 0), axis=1)
    hi = jnp.min(jnp.where(valid & jnp.logical_not(le), c, PROB_SCALE),
                 axis=1)
    return m, lo, hi


def _flatten(state):
    be, ma, bq, qf, seen, qexp = state
    return (be, *ma, *bq, *qf, *seen, *qexp)


def _unflatten(flat):
    be, flat = flat[0], flat[1:]
    ma, flat = list(flat[:2]), flat[2:]
    bq, flat = list(flat[:NQ]), flat[NQ:]
    qf, flat = list(flat[:NQ]), flat[NQ:]
    seen, qexp = list(flat[:NQ]), list(flat[NQ:])
    return be, ma, bq, qf, seen, qexp


# ---------------------------------------------------------------------------
# Decode


def _decode_kernel(buf_ref, starts_ref, rlens_ref, init_ref, _zeros_ref,
                   sym_ref, fin_ref, *, n, L, max_rlen, groups):
    lane = pl.program_id(0) * LB + jax.lax.broadcasted_iota(
        jnp.int32, (LB,), 0)
    starts = starts_ref[...]
    rlens = rlens_ref[...]
    mask16 = jnp.uint32(PROB_SCALE - 1)

    def byte_at(p):
        # clamped like XLA's gather: reads past the end return buf[n - 1]
        return plgpu.load(buf_ref.at[jnp.minimum(p, n - 1)]).astype(
            jnp.uint32)

    def read32(p):
        return (byte_at(p) | (byte_at(p + 1) << 8) | (byte_at(p + 2) << 16)
                | (byte_at(p + 3) << 24))

    regs = tuple(read32(starts + 4 * k) for k in range(4))
    ptr = starts + 16

    # symbol j of lane l lands at flat out[base + j * stride]: row-major
    # (L, max_rlen), or with `groups` the round-robin-undealt layout of
    # rans_wide.decode_lanes_wide
    if groups:
        per = L // groups
        base = (lane // per) * (max_rlen * per) + lane % per
        stride = per
    else:
        base = lane * max_rlen
        stride = 1

    def advance(x, lo, fq):
        return (fq.astype(jnp.uint32) * (x >> PROB_BITS) + (x & mask16)
                - lo.astype(jnp.uint32))

    def renorm(x, w, kb, active):
        # two refills always suffice (rans_wide.decode_lanes_wide.renorm);
        # bytes come from the step's 4-byte window at offset kb
        for _ in range(2):
            need = active & (x < RANS_BYTE_L)
            b = _select(kb, w)
            x = jnp.where(need, (x << 8) | b, x)
            kb = kb + jnp.where(need, 1, 0)
        return x, kb

    def body(i, carry):
        r0, r1, r2, r3, ptr = carry[:5]
        state = _unflatten(carry[5:])
        be, ma, bq = state[0], state[1], state[2]
        active = i < rlens
        pc = jnp.minimum(ptr, n - 1)
        w = [jnp.where(pc + k < n,
                       plgpu.load(buf_ref.at[jnp.minimum(pc + k, n - 1)]),
                       0).astype(jnp.uint32) for k in range(4)]
        kb = jnp.zeros((LB,), jnp.int32)

        # exponent symbol from state r0
        rng1 = (r0 & mask16).astype(jnp.int32)
        rng2 = (r1 & mask16).astype(jnp.int32)
        c7 = _cols(8) < 7
        e, lo, hi = _lookup(be, c7 & (be <= rng1[:, None]), c7)
        x, kb = renorm(advance(r0, lo, hi - lo), w, kb, active)
        r0, r1, r2, r3 = r1, r2, r3, jnp.where(active, x, r0)

        # mantissa symbol from (pre-rotation) state r1, model chosen by e
        cand = []
        for a in range(2):
            le = ma[a] <= rng2
            cand.append((jnp.where(le, 1, 0), jnp.where(le, ma[a], 0),
                         jnp.where(le, PROB_SCALE, ma[a])))
        for k in range(NQ):
            valid = _cols(_QW[k]) < _QA[k] - 1
            cand.append(_lookup(bq[k], valid & (bq[k] <= rng2[:, None]),
                                valid))
        # candidate e is the mantissa model of exponent e: 0, 1 adaptive,
        # 2 + k quasi model k
        m = _select(e, [c[0] for c in cand])
        lo = _select(e, [c[1] for c in cand])
        hi = _select(e, [c[2] for c in cand])
        x, kb = renorm(advance(r0, lo, hi - lo), w, kb, active)
        ptr = ptr + kb
        r0, r1, r2, r3 = r1, r2, r3, jnp.where(active, x, r0)

        state = _update(state, active, e, m)
        sym = jnp.where(active, _select(e, _EXP_BASE) + m, 0)
        plgpu.store(sym_ref.at[base + i * stride], sym.astype(jnp.uint16),
                    mask=active)
        return (r0, r1, r2, r3, ptr) + _flatten(state)

    steps = jnp.minimum(jnp.maximum(jnp.max(rlens), 0), max_rlen)
    carry = jax.lax.fori_loop(0, steps, body,
                              regs + (ptr,) + _flatten(_init_state(init_ref)))
    for k in range(4):
        fin_ref[k, :] = carry[k]


def _pad_pow2(buf):
    """buf zero-padded to a power-of-two length: the Triton route's block
    shapes must be powers of two."""
    n = buf.shape[0]
    p = 1 << max(n - 1, 1).bit_length()
    return jnp.pad(buf, (0, p - n)) if p > n else buf


@partial(jax.jit, static_argnames=("max_rlen", "groups", "interpret"))
def decode_lanes_wide_pallas(buf: jnp.ndarray, starts: jnp.ndarray,
                             rlens: jnp.ndarray, max_rlen: int,
                             groups: int = 0, interpret: bool = False):
    """Drop-in for rans_wide.decode_lanes_wide: buf uint8, starts/rlens
    (L,); returns (syms, ok) in the same layout, `groups` included."""
    L = starts.shape[0]
    if groups:
        assert L % groups == 0
    Lp = -(-L // LB) * LB
    n = buf.shape[0]
    padded = _pad_pow2(buf)
    starts_p = jnp.pad(starts.astype(jnp.int32), (0, Lp - L))
    rlens_p = jnp.pad(rlens.astype(jnp.int32), (0, Lp - L),
                      constant_values=-1)
    lane_spec = pl.BlockSpec((LB,), lambda b: (b,))
    whole = lambda shape: pl.BlockSpec(shape, lambda b: (0,) * len(shape))
    syms, fin = pl.pallas_call(
        partial(_decode_kernel, n=n, L=L, max_rlen=max_rlen, groups=groups),
        grid=(Lp // LB,),
        in_specs=[whole(padded.shape), lane_spec, lane_spec,
                  whole((8, 256)), whole((L * max_rlen,))],
        out_specs=[whole((L * max_rlen,)),
                   pl.BlockSpec((4, LB), lambda b: (0, b))],
        out_shape=[jax.ShapeDtypeStruct((L * max_rlen,), jnp.uint16),
                   jax.ShapeDtypeStruct((4, Lp), jnp.uint32)],
        input_output_aliases={4: 0},
        compiler_params=plgpu.CompilerParams(num_warps=_DECODE_WARPS,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name="rans_decode_wide",
    )(padded, starts_p, rlens_p, jnp.asarray(_INIT),
      jnp.zeros((L * max_rlen,), jnp.uint16))
    syms = (syms.reshape(groups, max_rlen * (L // groups)) if groups
            else syms.reshape(L, max_rlen))
    ok = jnp.all(fin[:, :L] == jnp.uint32(RANS_BYTE_L), axis=0) | (rlens < 0)
    return syms, ok


# ---------------------------------------------------------------------------
# Encode model pass (known symbols; ans.cpp:152-187)


def _pairs_kernel(chains_ref, rlens_ref, init_ref, _zl_ref, _zf_ref,
                  lows_ref, fqs_ref, ok_ref, *, L, max_rlen):
    lane = pl.program_id(0) * LB + jax.lax.broadcasted_iota(
        jnp.int32, (LB,), 0)
    rlens = rlens_ref[...]

    def known(c, idx, alpha, w):
        """(low, freq-or-0, last) of symbol idx in a tile of interior
        cums: freq as the uint16 cum difference, 0 for the last symbol
        (whose freq is 2^16 - low) and for an index past the alphabet
        (which rans_wide also reports as a zero-frequency op)."""
        col = _cols(w)
        top = jnp.minimum(idx, alpha - 1)
        lo = jnp.sum(jnp.where(col == (top - 1)[:, None], c, 0), axis=1)
        nxt = jnp.sum(jnp.where(col == idx[:, None], c, 0), axis=1)
        inner = idx < alpha - 1
        return lo, jnp.where(inner, (nxt - lo) & 0xFFFF, 0), idx == alpha - 1

    def body(i, carry):
        ok = carry[0]
        state = _unflatten(carry[1:])
        be, ma, bq = state[0], state[1], state[2]
        active = i < rlens
        sym = plgpu.load(chains_ref.at[lane * max_rlen + i], mask=active,
                         other=0).astype(jnp.int32)
        e = jnp.zeros((LB,), jnp.int32)
        for b in _EXP_BASE[1:]:
            e = e + jnp.where(sym >= b, 1, 0)
        m = sym - _select(e, _EXP_BASE)
        lo_e, fqp_e, last_e = known(be, e, 8, 8)
        cand = []
        for a in range(2):
            cand.append((jnp.where(m > 0, ma[a], 0),
                         jnp.where(m > 0, 0, ma[a]), m == 1))
        for k in range(NQ):
            cand.append(known(bq[k], m, _QA[k], _QW[k]))
        lo_m = _select(e, [c[0] for c in cand])
        fqp_m = _select(e, [c[1] for c in cand])
        last_m = _select(e, [c[2] for c in cand])
        fq_e = jnp.where(last_e, PROB_SCALE - lo_e, fqp_e)
        fq_m = jnp.where(last_m, PROB_SCALE - lo_m, fqp_m)
        good = ((last_e | (fqp_e > 0)) & (last_m | (fqp_m > 0))
                | jnp.logical_not(active))
        ok = ok & good
        at = lane * (2 * max_rlen) + 2 * i
        for j, (lo, fq) in enumerate(((lo_e, fq_e), (lo_m, fq_m))):
            plgpu.store(lows_ref.at[at + j], lo.astype(jnp.uint16),
                        mask=active)
            plgpu.store(fqs_ref.at[at + j], fq.astype(jnp.uint16),
                        mask=active)
        return (ok,) + _flatten(_update(state, active, e, m))

    steps = jnp.minimum(jnp.maximum(jnp.max(rlens), 0), max_rlen)
    carry = jax.lax.fori_loop(
        0, steps, body,
        (jnp.ones((LB,), jnp.bool_),) + _flatten(_init_state(init_ref)))
    ok_ref[...] = jnp.where(carry[0], 1, 0)


@partial(jax.jit, static_argnames=("max_rlen", "interpret"))
def model_pairs_wide_pallas(chains: jnp.ndarray, rlens: jnp.ndarray,
                            max_rlen: int, interpret: bool = False):
    """Drop-in for rans_wide.model_pairs_wide.  chains: (L, max_rlen)
    uint16; rlens (L,).  Returns (lows (L, 2*max_rlen) u16,
    fqs (L, 2*max_rlen) u16, ok (L,)); slots past a chain's rlen are 0."""
    L = chains.shape[0]
    Lp = -(-L // LB) * LB
    rlens_p = jnp.pad(rlens.astype(jnp.int32), (0, Lp - L))
    lane_spec = pl.BlockSpec((LB,), lambda b: (b,))
    whole = lambda shape: pl.BlockSpec(shape, lambda b: (0,) * len(shape))
    flat = (L * 2 * max_rlen,)
    lows, fqs, ok = pl.pallas_call(
        partial(_pairs_kernel, L=L, max_rlen=max_rlen),
        grid=(Lp // LB,),
        in_specs=[whole((L * max_rlen,)), lane_spec, whole((8, 256)),
                  whole(flat), whole(flat)],
        out_specs=[whole(flat), whole(flat), lane_spec],
        out_shape=[jax.ShapeDtypeStruct(flat, jnp.uint16),
                   jax.ShapeDtypeStruct(flat, jnp.uint16),
                   jax.ShapeDtypeStruct((Lp,), jnp.int32)],
        input_output_aliases={3: 0, 4: 1},
        compiler_params=plgpu.CompilerParams(num_warps=_PAIRS_WARPS,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name="rans_model_pairs_wide",
    )(chains.reshape(-1), rlens_p, jnp.asarray(_INIT),
      jnp.zeros(flat, jnp.uint16), jnp.zeros(flat, jnp.uint16))
    return (lows.reshape(L, 2 * max_rlen), fqs.reshape(L, 2 * max_rlen),
            ok[:L] != 0)
