"""Shared model-bank machinery for the device rANS kernels.

The entropy stage's per-chunk model state (1 exponent AdaptiveModel + 2
adaptive + 6 quasi mantissa models, ans.cpp:136-140 semantics) lives here as
a pytree of fixed-shape arrays so both the decode kernel (searchsorted
symbol lookup) and the encode kernel (known-symbol table lookup) share one
bit-exact update implementation (model.cpp:60-77 adaptive CDF mixing,
model.cpp:160-204 quasi rescale in exact unsigned arithmetic).
"""

import jax
import jax.numpy as jnp
import numpy as np

from ..format.constants import (
    MAX_MODELS,
    MODEL_SWITCH_THRESHOLD,
    PROB_BITS,
    PROB_SCALE,
    RANS_BYTE_L,
)
from ..format.tables import EXPONENT, MODEL_ALPHABET

RATE = 5
UPDATE_RATE = 64 << 10
QALPHA = 129  # widest quasi alphabet; all quasi state padded to this
NQ = MAX_MODELS - MODEL_SWITCH_THRESHOLD  # 6 quasi models (e = 2..7)
QALPHAS = np.asarray(MODEL_ALPHABET[MODEL_SWITCH_THRESHOLD:], dtype=np.int32)


def _adaptive_mix(alpha: int) -> np.ndarray:
    rows = np.ones((alpha, alpha + 1), dtype=np.int64)
    rows[:, 0] = 0
    for sym in range(alpha):
        rows[sym, sym + 1] += PROB_SCALE - alpha
    return np.cumsum(rows, axis=1).astype(np.int32)


def _adaptive_init(alpha: int) -> np.ndarray:
    scale = PROB_SCALE // alpha
    freqs = np.full(alpha, scale, dtype=np.int64)
    freqs[0] += PROB_SCALE - scale * alpha
    return np.concatenate([[0], np.cumsum(freqs)]).astype(np.int32)


def _quasi_init_cum() -> np.ndarray:
    """Initial padded cum tables for the 6 quasi models, padding = huge."""
    out = np.full((NQ, QALPHA + 1), 1 << 30, dtype=np.int32)
    for i, alpha in enumerate(QALPHAS):
        scale = PROB_SCALE // int(alpha)
        freqs = np.full(alpha, scale, dtype=np.int64)
        freqs[0] += PROB_SCALE - scale * int(alpha)
        out[i, : alpha + 1] = np.concatenate([[0], np.cumsum(freqs)])
    return out


# Constant tables (device-resident after first jit).
EXP_MIX = _adaptive_mix(MAX_MODELS)
EXP_INIT = _adaptive_init(MAX_MODELS)
MANT_ADAPT_MIX = np.stack([
    np.pad(_adaptive_mix(int(MODEL_ALPHABET[e])), ((0, 0), (0, 0)))
    for e in range(MODEL_SWITCH_THRESHOLD)
])  # alphas are both 2 -> shape (2, 2, 3)
MANT_ADAPT_INIT = np.stack([
    _adaptive_init(int(MODEL_ALPHABET[e])) for e in range(MODEL_SWITCH_THRESHOLD)
])
QUASI_INIT_CUM = _quasi_init_cum()
QMASK = (np.arange(QALPHA)[None, :] < QALPHAS[:, None])  # (6, 129) valid lanes


def init_bank():
    """Fresh per-chunk model state (ans.cpp:136-140)."""
    return dict(
        exp_cum=jnp.asarray(EXP_INIT),
        ma_cum=jnp.asarray(MANT_ADAPT_INIT),
        q_cum=jnp.asarray(QUASI_INIT_CUM),
        q_freqs=jnp.zeros((NQ, QALPHA), dtype=jnp.int32),
        q_seen=jnp.zeros(NQ, dtype=jnp.int32),
        q_exp=jnp.full(NQ, 8, dtype=jnp.int32),
    )


def adaptive_update(cum, mix_row):
    """CDF mixing toward the per-symbol target row (model.cpp:60-77):
    interior entries only; ends stay 0 / PROB_SCALE."""
    upd = cum + ((mix_row - cum) >> RATE)
    n = cum.shape[0]
    keep = (jnp.arange(n) == 0) | (jnp.arange(n) == n - 1)
    return jnp.where(keep, cum, upd)


def exp_lookup(bank, e):
    lo = bank["exp_cum"][e]
    return lo, bank["exp_cum"][e + 1] - lo


def exp_find(bank, rng):
    return jnp.searchsorted(bank["exp_cum"], rng, side="right").astype(jnp.int32) - 1


def exp_update(bank, e):
    bank = dict(bank)
    bank["exp_cum"] = adaptive_update(bank["exp_cum"], jnp.asarray(EXP_MIX)[e])
    return bank


def mant_find(bank, ei, qi, is_adaptive, rng):
    m_a = jnp.searchsorted(bank["ma_cum"][ei], rng, side="right").astype(jnp.int32) - 1
    m_q = jnp.searchsorted(bank["q_cum"][qi], rng, side="right").astype(jnp.int32) - 1
    return m_a, m_q, jnp.where(is_adaptive, m_a, m_q)


def mant_lookup(bank, ei, qi, is_adaptive, m):
    lo = jnp.where(is_adaptive, bank["ma_cum"][ei, m], bank["q_cum"][qi, m])
    hi = jnp.where(
        is_adaptive, bank["ma_cum"][ei, m + 1], bank["q_cum"][qi, m + 1]
    )
    return lo, hi - lo


def mant_update(bank, ei, qi, is_adaptive, m_a, m_q):
    """Post-symbol mantissa model update; masked to the active model kind."""
    bank = dict(bank)
    ma_cum, q_cum = bank["ma_cum"], bank["q_cum"]
    q_freqs, q_seen, q_exp = bank["q_freqs"], bank["q_seen"], bank["q_exp"]
    q_alphas = jnp.asarray(QALPHAS)
    q_mask = jnp.asarray(QMASK)

    new_ma = adaptive_update(
        ma_cum[ei], jnp.asarray(MANT_ADAPT_MIX)[ei, jnp.clip(m_a, 0, 1)]
    )
    bank["ma_cum"] = ma_cum.at[ei].set(
        jnp.where(is_adaptive, new_ma, ma_cum[ei])
    )

    qf = q_freqs[qi].at[m_q].add(jnp.where(is_adaptive, 0, PROB_BITS))
    qs = q_seen[qi] + jnp.where(is_adaptive, 0, 1)
    alpha = q_alphas[qi]
    lanes = q_mask[qi]

    def rescale(args):
        qf, _qcum, qexp = args
        total = jnp.sum(qf * lanes)
        # smallest log with (total >> log) + alpha <= PROB_SCALE
        logv = jax.lax.while_loop(
            lambda lg: ((total >> lg) + alpha) > PROB_SCALE,
            lambda lg: lg + 1,
            jnp.int32(0),
        )
        f = jnp.where(lanes, (qf >> logv) + 1, 0)
        t2 = jnp.sum(f)
        # model.cpp:183 is UNSIGNED arithmetic (ProbScale is unsigned int)
        # and the product never exceeds 2^32: exact uint32 divide
        prod = f.astype(jnp.uint32) << PROB_BITS
        q = (prod // t2.astype(jnp.uint32)).astype(jnp.int32)
        q = q.at[0].add(PROB_SCALE - jnp.sum(q * lanes))
        q = jnp.where(lanes, q, 0)
        cum = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(q)])
        cum = jnp.where(
            jnp.arange(QALPHA + 1) <= alpha, cum, jnp.int32(1 << 30)
        )
        new_exp = jnp.where(qexp < UPDATE_RATE, qexp << 1, UPDATE_RATE)
        return jnp.zeros_like(qf), cum, jnp.int32(0), new_exp

    def no_rescale(args):
        qf, qcum, qexp = args
        return qf, qcum, qs, qexp

    do_rescale = jnp.logical_and(jnp.logical_not(is_adaptive), qs > q_exp[qi])
    qf2, qcum2, qs2, qexp2 = jax.lax.cond(
        do_rescale, rescale, no_rescale, (qf, q_cum[qi], q_exp[qi])
    )
    bank["q_freqs"] = q_freqs.at[qi].set(qf2)
    bank["q_cum"] = q_cum.at[qi].set(qcum2)
    bank["q_seen"] = q_seen.at[qi].set(qs2)
    bank["q_exp"] = q_exp.at[qi].set(qexp2)
    return bank
