"""Filtered prefix doubling: suffix sort whose rounds shrink with the ties.

Plain doubling re-sorts all n positions every round, so inputs with long
common prefixes (periodic data, near-duplicate records) pay ~log2(LCP_max)
full sorts.  This variant (the standard discard/filter refinement of GPU
suffix sorting, see PAPERS.md) keeps the full-array rounds only while most
positions are unresolved, then compacts the still-tied sorted slots into a
static-size subset and refines only those:

  * ranks are head-index labels (rank = sorted position of the tie group's
    first member), so a tie group refines without renumbering anything
    outside itself — group members occupy a fixed global slot range;
  * the subset is compacted by ONE sort (sort-by-flag in place of a
    scatter) and only ever shrinks, so later
    rounds recompact within the subset at subset cost;
  * padding slots are real resolved (singleton) entries — refining them is
    a no-op, so no masking is needed anywhere.

Host-orchestrated: each round is a jitted call and the unresolved count is
fetched to pick full/subset/recompact transitions and the bucket size.
The single-jit sa_doubling_core (sa.py) remains for fully-fused callers
(the sharded codec step); both produce the identical suffix array.

STATUS — NOT wired into the default path, and not yet timed on the GPU.
Two formulations:

  * host-orchestrated (sa_filtered): two host dispatches per round;
  * device-resident (sa_doubling_filtered_core, single while_loop with a
    scalar lax.cond full/subset switch): the cond boundary may copy the
    big carried arrays every round.

On fully periodic data the tie count additionally stays above any useful
threshold until k reaches the period, so filtering cannot engage at all.
Both variants are correctness-proven against the spec (binary alphabets,
run-heavy, Fibonacci strings) and kept as groundwork: the approach needs
either cond-free carry aliasing or a Pallas formulation to pay off.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from jampack_jax.kernels.sa import _INIT_WORDS, _pack4


def _head_ranks_and_ties(bnd, n_or_m):
    """bnd[j] = True at group starts.  Returns (head-index rank per sorted
    slot, tied flag per slot)."""
    pos = jnp.arange(n_or_m, dtype=jnp.int32)
    head = jax.lax.cummax(jnp.where(bnd, pos, 0))
    closed = jnp.concatenate([bnd[1:], jnp.ones(1, dtype=bool)])
    tied = ~(bnd & closed)  # singleton iff group opens and closes at j
    return head, tied


@partial(jax.jit, static_argnames=("n",))
def init_pass(t: jnp.ndarray, n: int):
    t32 = t.astype(jnp.int32)
    pos = jnp.arange(n, dtype=jnp.int32)
    k0 = 4 * _INIT_WORDS
    words = [_pack4(t32, 4 * i, n) for i in range(_INIT_WORDS)]
    rem = jnp.minimum(n - pos, k0).astype(jnp.uint32)
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
    bnd = jnp.concatenate([jnp.ones(1, dtype=bool), neq])
    head, tied = _head_ranks_and_ties(bnd, n)
    _, rank = jax.lax.sort((order, head), num_keys=1, is_stable=False)
    return order, rank, prev_sorted, tied, jnp.sum(tied)


@partial(jax.jit, static_argnames=("n",))
def full_round(k, order, rank, prev_pos, n: int):
    """One all-positions doubling round; prev_pos is the constant
    position-space t[(i-1) mod n] payload, re-sorted fresh each round."""
    pos = jnp.arange(n, dtype=jnp.int32)
    key2 = jnp.where(pos + k < n, rank[jnp.minimum(pos + k, n - 1)], -1)
    k1s, k2s, order, prev_sorted = jax.lax.sort(
        (rank, key2, pos, prev_pos), num_keys=2, is_stable=True
    )
    bnd = jnp.concatenate(
        [jnp.ones(1, dtype=bool), (k1s[1:] != k1s[:-1]) | (k2s[1:] != k2s[:-1])]
    )
    head, tied = _head_ranks_and_ties(bnd, n)
    _, rank = jax.lax.sort((order, head), num_keys=1, is_stable=False)
    return order, rank, prev_sorted, tied, jnp.sum(tied)


@partial(jax.jit, static_argnames=("n", "M"))
def compact_full(tied, n: int, M: int):
    """The M sorted slots to keep working on: every tied slot plus enough
    resolved (no-op) padding slots, returned in ASCENDING slot order — the
    subset scatter requires idxs order == subset key order, and key1 is the
    global head slot."""
    flag = jnp.where(tied, 0, 1).astype(jnp.int32)
    pos = jnp.arange(n, dtype=jnp.int32)
    _, idxs = jax.lax.sort((flag, pos), num_keys=1, is_stable=True)
    return jax.lax.sort(idxs[:M])


@partial(jax.jit, static_argnames=("n", "M"))
def subset_round(k, idxs, order, rank, prev_sorted, n: int, M: int):
    """Refine the (<= M) still-tied sorted slots listed in idxs.

    idxs holds whole tie groups in ascending sorted order, padded with
    resolved slots; members of a group permute only within the group's
    fixed global slot range, so order/prev/rank update with M-sized
    scatters and everything outside the subset is untouched.
    """
    sub = jnp.arange(M, dtype=jnp.int32)
    si = order[idxs]
    pv = prev_sorted[idxs]
    key1 = rank[si]
    key2 = jnp.where(si + k < n, rank[jnp.minimum(si + k, n - 1)], -1)
    k1s, k2s, t_old, si_s, pv_s = jax.lax.sort(
        (key1, key2, sub, si, pv), num_keys=3, is_stable=True
    )
    del t_old
    order = order.at[idxs].set(si_s)
    prev_sorted = prev_sorted.at[idxs].set(pv_s)
    bnd = jnp.concatenate(
        [jnp.ones(1, dtype=bool), (k1s[1:] != k1s[:-1]) | (k2s[1:] != k2s[:-1])]
    )
    head_t = jax.lax.cummax(jnp.where(bnd, sub, 0))
    new_rank = idxs[head_t]
    rank = rank.at[si_s].set(new_rank)
    closed = jnp.concatenate([bnd[1:], jnp.ones(1, dtype=bool)])
    tied_sub = ~(bnd & closed)
    return order, rank, prev_sorted, tied_sub, jnp.sum(tied_sub)


@partial(jax.jit, static_argnames=("M", "M2"))
def compact_subset(idxs, tied_sub, M: int, M2: int):
    """Shrink the working set within the subset; ascending like compact_full.

    tied_sub is indexed by the LAST subset round's output order, which is
    exactly position-in-idxs (the scatter wrote back in idxs order), so
    selecting by flag then re-sorting the kept slots preserves whole tie
    groups."""
    flag = jnp.where(tied_sub, 0, 1).astype(jnp.int32)
    _, slot_sorted = jax.lax.sort((flag, idxs), num_keys=1, is_stable=True)
    return jax.lax.sort(slot_sorted[:M2])


def _bucket(m: int, n: int) -> int:
    """Smallest power-of-two working size >= m (bounded compile variants)."""
    M = 1 << max(m - 1, 1).bit_length()
    return min(M, n)


def sa_filtered(t: np.ndarray):
    """Host-orchestrated filtered doubling.  Returns (sa, isa, prev_sorted)
    device arrays — identical results to sa_doubling_core."""
    t = np.asarray(t, dtype=np.uint8)
    n = int(t.size)
    td = jnp.asarray(t)
    t32 = td.astype(jnp.int32)
    prev_pos = jnp.concatenate([t32[n - 1 :], t32[: n - 1]])
    order, rank, prev_sorted, tied, m = init_pass(td, n)
    m = int(m)
    k = 4 * _INIT_WORDS
    idxs = None
    M = 0
    while m > 0 and k < 2 * n:
        if m > n // 8:
            order, rank, prev_sorted, tied, m_dev = full_round(
                jnp.int32(k), order, rank, prev_pos, n
            )
            m = int(m_dev)
        else:
            want = _bucket(m, n)
            if idxs is None:
                idxs = compact_full(tied, n, want)
                M = want
            elif want < M // 2:
                idxs = compact_subset(idxs, tied, M, want)
                M = want
            order, rank, prev_sorted, tied, m_dev = subset_round(
                jnp.int32(k), idxs, order, rank, prev_sorted, n, M
            )
            m = int(m_dev)
        k *= 2
    # rank is now the exact ISA (head-index of a singleton = its position)
    return order, rank, prev_sorted


def suffix_array_device_filtered(t: np.ndarray) -> np.ndarray:
    t = np.asarray(t, dtype=np.uint8)
    if t.size == 0:
        return np.zeros(0, dtype=np.int32)
    if t.size == 1:
        return np.zeros(1, dtype=np.int32)
    order, _, _ = sa_filtered(t)
    return np.asarray(jax.device_get(order), dtype=np.int32)


def sa_doubling_filtered_core(t: jnp.ndarray, n: int):
    """Device-resident filtered doubling: one while_loop whose body picks a
    full round or a compacted-subset round with a scalar lax.cond, so the
    filtering pays no per-round host dispatch.  Single static bucket
    M = n//8; the subset is compacted once, on first entry.

    Returns (order, rank=ISA, prev_sorted) — identical to sa_doubling_core.
    """
    M = max(n // 8, 1)
    t32 = t.astype(jnp.int32)
    prev_pos = jnp.concatenate([t32[n - 1 :], t32[: n - 1]])
    order, rank, prev_sorted, tied, m = init_pass(t, n)

    def cond(c):
        return jnp.logical_and(c["m"] > 0, c["k"] < 2 * n)

    def full_branch(c):
        order, rank, prev_sorted, tied, m = full_round(
            c["k"], c["order"], c["rank"], prev_pos, n
        )
        return dict(c, order=order, rank=rank, prev=prev_sorted, tied=tied,
                    m=m, k=c["k"] * 2)

    def subset_branch(c):
        idxs = jax.lax.cond(
            c["have_idxs"],
            lambda _: c["idxs"],
            lambda _: compact_full(c["tied"], n, M),
            None,
        )
        order, rank, prev_sorted, _, m = subset_round(
            c["k"], idxs, c["order"], c["rank"], c["prev"], n, M
        )
        return dict(c, order=order, rank=rank, prev=prev_sorted, m=m,
                    idxs=idxs, have_idxs=jnp.bool_(True), k=c["k"] * 2)

    def body(c):
        return jax.lax.cond(
            c["m"] <= M, subset_branch, full_branch, c
        )

    carry = dict(
        order=order, rank=rank, prev=prev_sorted, tied=tied, m=m,
        idxs=jnp.zeros(M, jnp.int32), have_idxs=jnp.bool_(False),
        k=jnp.int32(4 * _INIT_WORDS),
    )
    carry = jax.lax.while_loop(cond, body, carry)
    return carry["order"], carry["rank"], carry["prev"]


_sa_doubling_filtered = partial(jax.jit, static_argnames=("n",))(
    sa_doubling_filtered_core
)
