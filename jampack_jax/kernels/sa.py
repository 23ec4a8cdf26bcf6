"""Device suffix-array construction: prefix doubling on XLA sort.

Replaces the role of the reference's vendored divsufsort (divsufsort.cpp)
with an O(n log^2 n) rank-doubling pipeline that is all sorts, gathers and
segmented scans — the shapes XLA handles well.  Deterministic and
memory-frugal: peak device footprint ~ 3 int32 arrays of n.

The early-exit on fully distinct ranks makes typical text converge in
~log2(LCP_max) rounds rather than log2(n).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _pack4(t32: jnp.ndarray, off: int, n: int) -> jnp.ndarray:
    """Big-endian pack of bytes [i+off, i+off+4) per position, 0-padded past
    the end.  uint32 so byte order == lexicographic order for lax.sort."""
    words = jnp.zeros(n, dtype=jnp.uint32)
    for j in range(4):
        s = off + j
        if s < n:
            b = jnp.zeros(n, dtype=jnp.uint32).at[: n - s].set(
                t32[s:].astype(jnp.uint32)
            )
        else:
            b = jnp.zeros(n, dtype=jnp.uint32)
        words = words | (b << (8 * (3 - j)))
    return words


# the initial sort covers k0 = 4*_INIT_WORDS bytes: each extra packed word
# adds a sort operand, each missing one a doubling round on data with
# long repeats
_INIT_WORDS = 3


def _sa_doubling_sorted(t: jnp.ndarray, n: int):
    """Prefix doubling with the per-round ISA sort hoisted to the ROUND
    START: the loop carries the rank in SORTED space, so no position-space
    ISA is built after the final round; callers that need it take one
    1-key sort (sa_doubling_core).  Two sorts per round.

    Returns (order, rank_sorted, prev_sorted)."""
    # Initial rank: exact order of the min(k0, remaining)-byte prefix, built
    # from one multi-key sort — k0/4 packed 4-byte words plus
    # min(remaining, k0) as the tiebreak.  Zero-padding past the end can
    # only tie with real zero bytes (never invert, since 0 is the minimum),
    # and those ties are exactly the ones the remaining-length key breaks
    # (shorter suffix first, as the reference's rotation order requires).
    # Doubling then starts at k0; on text-like data the init alone resolves
    # nearly all ranks.
    t32 = t.astype(jnp.int32)
    pos = jnp.arange(n, dtype=jnp.int32)
    k0 = 4 * _INIT_WORDS
    words = [_pack4(t32, 4 * i, n) for i in range(_INIT_WORDS)]
    rem = jnp.minimum(n - pos, k0).astype(jnp.uint32)
    # prev[i] = t[(i-1) mod n] rides every sort as a payload operand, so the
    # BWT emission needs no random gather at all: the last sort delivers
    # t[SA[j]-1] already in suffix order (see bwt_from_prev_sorted)
    prev = jnp.concatenate([t32[n - 1 :], t32[: n - 1]])
    sorted_ops = jax.lax.sort(
        tuple(words) + (rem, pos, prev), num_keys=_INIT_WORDS + 1,
        is_stable=True,
    )
    order = sorted_ops[-2]
    prev_sorted = sorted_ops[-1]
    neq = jnp.zeros(n - 1, dtype=bool)
    for key in sorted_ops[: _INIT_WORDS + 1]:
        neq = neq | (key[1:] != key[:-1])
    boundaries = jnp.concatenate(
        [jnp.ones(1, dtype=jnp.int32), neq.astype(jnp.int32)]
    )
    init_rank = jnp.cumsum(boundaries) - 1
    init_done = init_rank[-1] == n - 1

    def round_fn(k, rank_sorted, order):
        # ISA build at round start: a sort by the permutation key in place
        # of a scatter
        _, rank = jax.lax.sort((order, rank_sorted), num_keys=1,
                               is_stable=False)
        # per-position keys: (rank[i], rank[i+k] or -1); two-key lexicographic
        # lax.sort avoids any packed-key overflow at 8M+ scale.  rank[i+k]
        # is a CONTIGUOUS dynamic_slice, not a shift-of-iota gather
        pos = jnp.arange(n, dtype=jnp.int32)
        key1 = rank
        key2 = jax.lax.dynamic_slice(
            jnp.concatenate([rank, jnp.full(n, -1, jnp.int32)]),
            (jnp.minimum(k, n),), (n,))
        key2 = jnp.where(pos + k < n, key2, -1)
        k1s, k2s, order, prev_sorted = jax.lax.sort(
            (key1, key2, pos, prev), num_keys=2, is_stable=True
        )
        boundaries = jnp.concatenate(
            [
                jnp.ones(1, dtype=jnp.int32),
                ((k1s[1:] != k1s[:-1]) | (k2s[1:] != k2s[:-1])).astype(jnp.int32),
            ]
        )
        new_rank = jnp.cumsum(boundaries) - 1
        return new_rank, order, prev_sorted, new_rank[-1] == n - 1

    def cond(carry):
        _, _, _, done, k = carry
        return jnp.logical_and(jnp.logical_not(done), k < 2 * n)

    def body(carry):
        rank_sorted, order, prev_sorted, _, k = carry
        rank_sorted, order, prev_sorted, done = round_fn(k, rank_sorted,
                                                         order)
        return rank_sorted, order, prev_sorted, done, k * 2

    rank_sorted, order, prev_sorted, done, _ = jax.lax.while_loop(
        cond, body,
        (init_rank, order, prev_sorted, init_done,
         jnp.array(k0, dtype=jnp.int32)),
    )
    return order, rank_sorted, prev_sorted


def sa_doubling_core(t: jnp.ndarray, n: int):
    order, rank_sorted, prev_sorted = _sa_doubling_sorted(t, n)
    # rank is the inverse permutation (ISA) at termination;
    # prev_sorted[j] = t[(sa[j]-1) mod n], the gather-free BWT payload.
    _, rank = jax.lax.sort((order, rank_sorted), num_keys=1, is_stable=False)
    return order, rank, prev_sorted


_sa_doubling = partial(jax.jit, static_argnames=("n",))(sa_doubling_core)


def _sa_doubling_dyn_sorted(t: jnp.ndarray, n):
    """Prefix-doubling SA with TRACED length n over a static-capacity
    buffer t (cap,) — the encode-side counterpart of the decode chain's
    ibwt_dyn_core bucketing (one compile per pow2 bucket, not per exact
    block length).  Same ISA-at-round-start structure as
    _sa_doubling_sorted; returns (order, rank_sorted, prev_sorted).

    Positions >= n carry maximal sort keys at every round, so they stay
    strictly after every real suffix: the first n entries of `order` are
    the SA and the first n entries of `prev_sorted` are
    t[(SA[j]-1) mod n] (the gather-free BWT payload).  Requires n >= 2.
    """
    cap = t.shape[0]
    pos = jnp.arange(cap, dtype=jnp.int32)
    valid = pos < n
    t32 = jnp.where(valid, t.astype(jnp.int32), 0)
    k0 = 4 * _INIT_WORDS
    # zero-masking past n makes the static packs read exactly the
    # zero-padding the length-key tiebreak expects (see sa_doubling_core);
    # invalid positions get MAXIMAL keys on every operand (a valid pack
    # can reach 0xFFFFFFFF too — four 0xFF bytes — but its length key is
    # <= k0, so the tiebreak still orders every invalid strictly last)
    words = [jnp.where(valid, _pack4(t32, 4 * i, cap),
                       jnp.uint32(0xFFFFFFFF)) for i in range(_INIT_WORDS)]
    rem = jnp.where(valid, jnp.minimum(n - pos, k0).astype(jnp.uint32),
                    jnp.uint32(0xFFFFFFFF))
    prev = jnp.concatenate([t32[:1], t32[:-1]])
    prev = prev.at[0].set(t32[jnp.maximum(n - 1, 0)])
    sorted_ops = jax.lax.sort(
        tuple(words) + (rem, pos, prev), num_keys=_INIT_WORDS + 1,
        is_stable=True,
    )
    order = sorted_ops[-2]
    prev_sorted = sorted_ops[-1]
    neq = jnp.zeros(cap - 1, dtype=bool)
    for key in sorted_ops[: _INIT_WORDS + 1]:
        neq = neq | (key[1:] != key[:-1])
    boundaries = jnp.concatenate(
        [jnp.ones(1, dtype=jnp.int32), neq.astype(jnp.int32)]
    )
    init_rank = jnp.cumsum(boundaries) - 1
    # done iff the first n sorted ranks are distinct; invalid positions
    # always rank past them (their keys are strictly greater), so the
    # check is rank-at-sorted-position n-1 == n-1
    init_done = init_rank[jnp.maximum(n - 1, 0)] == n - 1

    def round_fn(k, rank_sorted, order):
        _, rank = jax.lax.sort((order, rank_sorted), num_keys=1,
                               is_stable=False)
        pos = jnp.arange(cap, dtype=jnp.int32)
        key1 = rank
        key2 = jax.lax.dynamic_slice(
            jnp.concatenate([rank, jnp.full(cap, -1, jnp.int32)]),
            (jnp.minimum(k, cap),), (cap,))
        key2 = jnp.where(pos + k < n, key2, -1)
        k1s, k2s, order, prev_sorted = jax.lax.sort(
            (key1, key2, pos, prev), num_keys=2, is_stable=True
        )
        boundaries = jnp.concatenate(
            [
                jnp.ones(1, dtype=jnp.int32),
                ((k1s[1:] != k1s[:-1])
                 | (k2s[1:] != k2s[:-1])).astype(jnp.int32),
            ]
        )
        new_rank = jnp.cumsum(boundaries) - 1
        return new_rank, order, prev_sorted, \
            new_rank[jnp.maximum(n - 1, 0)] == n - 1

    def cond(carry):
        _, _, _, done, k = carry
        return jnp.logical_and(jnp.logical_not(done), k < 2 * n)

    def body(carry):
        rank_sorted, order, prev_sorted, _, k = carry
        rank_sorted, order, prev_sorted, done = round_fn(k, rank_sorted,
                                                         order)
        return rank_sorted, order, prev_sorted, done, k * 2

    rank_sorted, order, prev_sorted, done, _ = jax.lax.while_loop(
        cond, body,
        (init_rank, order, prev_sorted, init_done,
         jnp.array(k0, dtype=jnp.int32)),
    )
    return order, rank_sorted, prev_sorted


def sa_doubling_dyn_core(t: jnp.ndarray, n):
    """(order, rank, prev_sorted) with the full position-space ISA."""
    order, rank_sorted, prev_sorted = _sa_doubling_dyn_sorted(t, n)
    _, rank = jax.lax.sort((order, rank_sorted), num_keys=1, is_stable=False)
    return order, rank, prev_sorted


def bwt_from_prev_sorted(prev_sorted: jnp.ndarray, idx: jnp.ndarray,
                         nlen: int) -> jnp.ndarray:
    """Gather-free BWT emission (bwt.cpp:50-58): prev_sorted[j] =
    t[(sa[j]-1) mod n] came out of the suffix sort as a payload, so the
    primary-row drop is a shift-and-select.  out[0] = t[nlen-1] =
    prev_sorted[idx] (the row where sa[j] = 0)."""
    pos = jnp.arange(nlen, dtype=jnp.int32)
    shifted = jnp.concatenate([prev_sorted[:1], prev_sorted[:-1]])
    out = jnp.where(pos <= idx, shifted, prev_sorted)
    out = jnp.where(pos == 0, prev_sorted[idx], out)
    return out.astype(jnp.uint8)


_bwt_from_prev = partial(jax.jit, static_argnames=("nlen",))(
    bwt_from_prev_sorted
)


def suffix_array_device(t: np.ndarray) -> np.ndarray:
    t = np.asarray(t, dtype=np.uint8)
    n = t.size
    if n == 0:
        return np.zeros(0, dtype=np.int32)
    if n == 1:
        return np.zeros(1, dtype=np.int32)
    order, _, _ = _sa_doubling(jnp.asarray(t), n)
    return np.asarray(jax.device_get(order), dtype=np.int32)


def bwt_emit_core(t: jnp.ndarray, sa: jnp.ndarray, idx: jnp.ndarray, nlen: int):
    """Emit BWT rows with the primary-index row dropped (bwt.cpp:50-58).

    One random gather total: out[i] = t[(sa[j]-1) mod nlen] with
    j = i-1 for 1 <= i <= idx, j = i for i > idx, out[0] = t[nlen-1];
    the j indirection is a shift-and-select on sa, not a second gather.
    idx = position of suffix 0 in sa (= ISA[0], free from _sa_doubling).
    """
    pos = jnp.arange(nlen, dtype=jnp.int32)
    sa_shift = jnp.concatenate([sa[:1], sa[:-1]])  # sa[i-1] (i=0 unused)
    sa_j = jnp.where(pos <= idx, sa_shift, sa)
    out = t[(sa_j - 1) % nlen]
    out = jnp.where(pos == 0, t[nlen - 1], out)
    return out


_bwt_emit = partial(jax.jit, static_argnames=("nlen",))(bwt_emit_core)


def _bwt_from_sa(t: jnp.ndarray, sa: jnp.ndarray, nlen: int):
    """Compat wrapper when only the SA is at hand: derives idx by argmin."""
    idx = jnp.argmin(sa)
    return _bwt_emit(t, sa, idx, nlen), idx


def forward_bwt_device(data: np.ndarray, units: int = 120) -> np.ndarray:
    """Device-side forward BWT; format-identical to stages.bwt.forward_bwt."""
    t = np.asarray(data, dtype=np.uint8)
    n = t.size
    out = np.empty(n + units * 4, dtype=np.uint8)
    remainder = n % units
    nlen = n - remainder
    out[nlen:n] = t[nlen:n]
    if nlen > 0:
        td = jnp.asarray(t[:nlen])
        order, isa, prev_sorted = _sa_doubling(td, nlen)
        bwt = _bwt_from_prev(prev_sorted, isa[0], nlen=nlen)
        step = nlen // units
        anchors = isa[: units * step : step] + 1  # ISA[u*step]+1, bwt.cpp:44-48
        out[:nlen] = np.asarray(jax.device_get(bwt))
        out[n:] = (
            np.asarray(jax.device_get(anchors), dtype="<i4").view(np.uint8)
        )
    else:
        out[n:] = 0
    return out
