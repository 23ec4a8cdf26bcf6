"""Device structured-rANS chunk decoder.

One chunk is an irreducibly serial chain (adaptive models update per
symbol), so the kernel is a `fori_loop` whose body does alphabet-wide
*vector* work: CDF mixing updates (<=129-wide VPU ops), searchsorted
symbol lookups, and mask-unrolled byte renormalization.  Throughput comes
from chunk parallelism (P5/P6 of the survey): many chunks decode
concurrently via `jax.vmap` across the padded chunk batch — thousands per
pod once blocks are sharded — and, in JTX wide-interleave streams, across
the lanes inside each chunk.

Bit-exact contract: identical int32 semantics to stages/models.py (and thus
to the reference's model.cpp / rans_byte.hpp / ans.cpp decode loop).  The
model-state machinery is shared with the encode kernel (rans_common.py).
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
from .rans_common import NQ, exp_find, exp_lookup, exp_update, init_bank, \
    mant_find, mant_lookup, mant_update


def _renorm(x, ptr, buf):
    """Unrolled byte renormalization (max 2 refills from a normalized state)."""
    for _ in range(3):
        need = x < RANS_BYTE_L
        x = jnp.where(need, (x << 8) | buf[ptr].astype(jnp.uint32), x)
        ptr = jnp.where(need, ptr + 1, ptr)
    return x, ptr


@partial(jax.jit, static_argnames=("max_rlen",))
def decode_chunk_syms(buf: jnp.ndarray, start: jnp.ndarray, rlen: jnp.ndarray,
                      max_rlen: int) -> jnp.ndarray:
    """Decode the structured 16-bit symbols of one chunk chain.

    buf: uint8 array containing the rANS payload at offset `start`
    rlen: number of symbols; max_rlen: static padded loop bound.
    Returns uint16 symbols padded to max_rlen.
    """
    buf = buf.astype(jnp.uint32)
    mask16 = jnp.uint32(PROB_SCALE - 1)

    # init 4 interleaved states (little-endian 4-byte each)
    def read32(p):
        return (buf[p] | (buf[p + 1] << 8) | (buf[p + 2] << 16) | (buf[p + 3] << 24))

    R = jnp.stack([read32(start + 4 * i) for i in range(4)]).astype(jnp.uint32)
    ptr = start + 16

    bank = init_bank()
    exponent = jnp.asarray(EXPONENT.astype(np.int32))
    syms = jnp.zeros(max_rlen, dtype=jnp.uint16)

    def body(i, carry):
        R, ptr, bank, syms = carry

        # ---- exponent symbol (adaptive, alpha=8)
        x = R[0]
        rng = (x & mask16).astype(jnp.int32)
        e = exp_find(bank, rng)
        lo, fq = exp_lookup(bank, e)
        x = fq.astype(jnp.uint32) * (x >> PROB_BITS) + (x & mask16) - lo.astype(jnp.uint32)
        x, ptr = _renorm(x, ptr, buf)
        bank = exp_update(bank, e)
        R = jnp.stack([R[1], R[2], R[3], x])

        # ---- mantissa symbol
        x = R[0]
        rng = (x & mask16).astype(jnp.int32)
        is_adaptive = e < MODEL_SWITCH_THRESHOLD
        ei = jnp.clip(e, 0, MODEL_SWITCH_THRESHOLD - 1)
        qi = jnp.clip(e - MODEL_SWITCH_THRESHOLD, 0, NQ - 1)

        m_a, m_q, m = mant_find(bank, ei, qi, is_adaptive, rng)
        lo, fq = mant_lookup(bank, ei, qi, is_adaptive, m)
        x = fq.astype(jnp.uint32) * (x >> PROB_BITS) + (x & mask16) - lo.astype(jnp.uint32)
        x, ptr = _renorm(x, ptr, buf)
        R = jnp.stack([R[1], R[2], R[3], x])

        bank = mant_update(bank, ei, qi, is_adaptive, m_a, m_q)

        sym = (exponent[e] + m).astype(jnp.uint16)
        syms = syms.at[i].set(sym)
        return R, ptr, bank, syms

    init = (R, ptr, bank, syms)
    R, ptr, _, syms = jax.lax.fori_loop(0, rlen, body, init)
    ok = jnp.all(R == jnp.uint32(RANS_BYTE_L))
    return syms, ok


def decode_chunk_device(payload: np.ndarray, rlen: int) -> np.ndarray:
    """Host wrapper: decode one chunk's symbols on device."""
    buf = jnp.asarray(np.asarray(payload, dtype=np.uint8))
    max_rlen = int(rlen)
    syms, ok = decode_chunk_syms(buf, jnp.int32(0), jnp.int32(rlen), max_rlen)
    if not bool(ok):
        raise ValueError("invalid rANS state")
    return np.asarray(jax.device_get(syms))[:rlen]


def decode_lanes_device(buf: np.ndarray, starts: np.ndarray,
                     rlens: np.ndarray) -> np.ndarray:
    """Host wrapper: decode a batch of independent chains (the lanes of JTX
    chunks, or whole chunks in the reference layout) on device in lockstep
    (survey P5/P6) via the lane-vectorized kernel (rans_wide.py).

    buf: the whole ANS stream; starts[l]: payload offset of chain l;
    rlens[l]: symbols owned by chain l.  Returns (L, max_rlen) uint16.
    """
    from .rans_wide import decode_lanes_wide

    max_rlen = int(np.max(rlens)) if rlens.size else 0
    if max_rlen == 0:
        # still enforce the final-state invariant (ans.cpp:91-92): an empty
        # chain is exactly the 16 flushed state bytes, all == RANS_BYTE_L
        buf_h = np.asarray(buf, dtype=np.uint8)
        for s in np.asarray(starts, dtype=np.int64):
            states = buf_h[s : s + 16].view("<u4")
            if states.size < 4 or not np.all(states == RANS_BYTE_L):
                raise ValueError("invalid rANS state")
        return np.zeros((len(starts), 0), dtype=np.uint16)

    # bucket every shape to a power of two so compile variants stay bounded;
    # the kernel's loop bound is traced, so width padding costs no steps and
    # rlens = -1 marks batch-padding lanes
    def _pow2(v: int) -> int:
        return 1 << max(int(v) - 1, 1).bit_length()

    L = len(starts)
    Lp = _pow2(L)
    buf_h = np.asarray(buf, dtype=np.uint8)
    buf_p = np.zeros(_pow2(buf_h.size + 16), dtype=np.uint8)
    buf_p[: buf_h.size] = buf_h
    starts_p = np.zeros(Lp, dtype=np.int32)
    starts_p[:L] = starts
    rlens_p = np.full(Lp, -1, dtype=np.int32)
    rlens_p[:L] = rlens
    syms, ok = decode_lanes_wide(
        jnp.asarray(buf_p),
        jnp.asarray(starts_p),
        jnp.asarray(rlens_p),
        _pow2(max_rlen),
    )
    if not bool(jnp.all(ok)):
        raise ValueError("invalid rANS state")
    return np.asarray(jax.device_get(syms))[:L]
