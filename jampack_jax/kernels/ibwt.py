"""Device inverse Burrows-Wheeler transform.

The reference's "120 parallel decode units" trick (CUDA kernel bwt.cpp:8-19,
anchor planting bwt.cpp:44-61) generalizes here to K independent LF-chains
chased in lockstep with vectorized gathers:

  * LF map build = stable sort of BWT positions by symbol with the
    primary-index adjustment (bwt.cpp:141-174 semantics) — an XLA sort.
  * Chase: p <- LF[p-1]; out[:, i] = bwt[p - (p >= idx)] — a fori_loop of
    K-wide gathers, state in registers, K = 120 for reference streams
    and lane-scaled (e.g. 2048) for native streams.

Throughput is gather-latency bound; it scales with K, which is why the
anchor count is a stream parameter in native mode.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..format.constants import BWT_UNITS


def combined_map_core(bwt: jnp.ndarray, idx: jnp.ndarray, nlen: int) -> jnp.ndarray:
    """C[j] = (LF[j] << 8) | emitted-byte-when-stepping-through-j.

    The chase emits bwt[p' - (p' >= idx)] after p' = LF[p-1]; algebraically
    bwt_adjusted[positions[j]] == bwt[j], so the byte to emit for entry j is
    just the value-sorted BWT — the same single stable sort yields both the
    LF pointer and the payload byte, fusing the two chase gathers into one.
    The primary-index position adjustment positions[order] is elementwise
    (order + (order >= idx)), not a gather: the whole map costs one sort.

    uint32 packing: lf <= nlen must stay < 2^24 (an int32 pack silently
    overflowed at nlen > 2^23 — caught on an 8,388,840-byte stage buffer).
    Callers with nlen >= 2^24 must use the split two-gather path.
    """
    assert nlen < (1 << 24), "combined map packing needs nlen < 2^24"
    sorted_bwt, order = jax.lax.sort(
        (bwt, jnp.arange(nlen, dtype=jnp.int32)), num_keys=1, is_stable=True
    )
    lf = (order + (order >= idx).astype(jnp.int32)).astype(jnp.uint32)
    return (lf << 8) | sorted_bwt.astype(jnp.uint32)


_combined_map = partial(jax.jit, static_argnames=("nlen",))(combined_map_core)


def chase_combined_core(cmap: jnp.ndarray, anchors: jnp.ndarray, nlen: int,
                        units: int) -> jnp.ndarray:
    step = nlen // units
    out = jnp.zeros((step, units), dtype=jnp.uint8)

    def body(i, carry):
        p, out = carry
        c = cmap[p - 1]
        p = (c >> 8).astype(jnp.int32)
        out = jax.lax.dynamic_update_slice(
            out, (c & 0xFF).astype(jnp.uint8)[None, :], (i, 0)
        )
        return p, out

    _, out = jax.lax.fori_loop(0, step, body, (anchors, out))
    return out.T.reshape(-1)


_chase_combined = partial(jax.jit, static_argnames=("nlen", "units"))(
    chase_combined_core
)


def inverse_bwt_device(buf: np.ndarray, units: int = BWT_UNITS) -> np.ndarray:
    """Drop-in replacement for stages.bwt.inverse_bwt running on device.

    `units` is the number of chains actually chased; any divisor-compatible
    count works because anchors are equally spaced in output space — we
    always use all transmitted anchors for maximum parallelism.

    Sizes are pow2-bucketed and the actual length is traced (via
    device_stages.ibwt_dyn_core), so decoding a stream of blocks with
    varying stage sizes reuses ONE compile per bucket instead of paying a
    fresh multi-minute XLA compile per distinct length.
    """
    from .device_stages import ibwt_dyn_core

    buf = np.asarray(buf, dtype=np.uint8)
    n = buf.size - units * 4
    if n <= 0 or n - (n % units) <= 0:
        # tiny stream: raw tail only (plus anchors)
        return buf[:max(n, 0)].copy()
    cap = 1 << max((buf.size - 1).bit_length(), 8)
    key = (cap, units)
    fn = _DYN_JITS.get(key)
    if fn is None:
        fn = jax.jit(partial(ibwt_dyn_core, units=units, out_cap=cap))
        _DYN_JITS[key] = fn
    padded = np.zeros(cap, dtype=np.uint8)
    padded[: buf.size] = buf
    out, out_len, ok = fn(jnp.asarray(padded), buf.size)
    out = np.asarray(jax.device_get(out))
    if not bool(ok):
        raise ValueError("invalid anchor table")
    return out[:n]


_DYN_JITS = {}


def plant_anchors(sa: np.ndarray, nlen: int, units: int) -> np.ndarray:
    """Anchor planting for arbitrary unit counts (forward side, bwt.cpp:44-48)."""
    step = nlen // units
    anchors = np.zeros(units, dtype=np.int32)
    pos = np.flatnonzero((sa % step) == 0)
    take = sa[pos] // step
    keep = take < units
    anchors[take[keep]] = pos[keep]
    return anchors + 1
