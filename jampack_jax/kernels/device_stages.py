"""Device-resident decode-stage kernels with dynamic lengths.

Every core here is jittable with *traced* actual lengths and *static*
capacity bounds, so the full decode chain — entropy symbols -> RLE0 ->
SRC rank -> inverse BWT -> LZ expansion -> Lpx -> filters — can run
device-resident under one jit (and under shard_map across a mesh) on real
archive blocks whose stage lengths are data-dependent.  Each kernel is
bit-exact with its executable-spec counterpart in stages/.

Design notes per kernel:

* RLE0 decode (rle.cpp:52-74): fully vectorized.  Runs of {0,1} symbols
  are segmented with a scan; each run's binary value is a segment-sum of
  bits scaled by position; nonzero symbols scatter to their exclusive-scan
  output positions into a zero-initialised buffer (the zeros between them
  ARE the decoded zero runs).
* SRC rank decode (rank.cpp:96-151): irreducibly serial per chunk — the
  MTF table walk is data-dependent — so the kernel carries an explicit
  chunk-lane axis and decodes all chunks of a block in lockstep
  (survey P5: chunk parallelism is the throughput axis).
* LZ77 expansion (lz77.cpp:678-714): a bounded on-device token parse
  (while_loop over tokens, scalar varint reads) followed by a vectorized
  region fill and the pointer-doubling resolve from lz_expand.py.
* Filters decode (filters.cpp:442-490): chunk headers sit at fixed
  strides; all-config transforms are vectorized (delta = masked cumsum,
  inline delta = stride-doubling prefix sum, channel unreorder = a
  computed gather); the serial LPC recurrence runs under a block-level
  cond only when some chunk actually chose LPC.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..format.constants import FILTER_BLOCK_SIZE

_FBS = FILTER_BLOCK_SIZE


# ---------------------------------------------------------------------------
# RLE0 decode


def rle0_decode_core(syms: jnp.ndarray, rlen, olen, out_cap: int):
    """syms: (S,) uint16 padded; rlen/olen traced actuals.
    Returns (out (out_cap,) uint8, ok bool).

    Fully scan-based: run boundaries, per-run binary values and output
    positions all come from cumsum/cummax passes — no segment scatters
    (scans are bandwidth-cheap; three 16M-element scatters are not)."""
    S = syms.shape[0]
    idx = jnp.arange(S, dtype=jnp.int32)
    valid = idx < rlen
    v = syms.astype(jnp.int32)
    is_bit = valid & (v <= 1)
    prev_bit = jnp.concatenate([jnp.zeros(1, bool), is_bit[:-1]])
    next_bit = jnp.concatenate([is_bit[1:], jnp.zeros(1, bool)])
    run_start = is_bit & ~prev_bit
    run_end = is_bit & ~next_bit
    # end index of each position's run: NEAREST end marker at or after p
    # (reverse cummin over marked indices)
    endi = jnp.flip(jax.lax.cummin(
        jnp.flip(jnp.where(run_end, idx, jnp.int32(S)))))
    # value = (1 << run_len) | bits: bit at j contributes bit << (end - j)
    shift = jnp.clip(endi - idx, 0, 31)
    contrib = jnp.where(is_bit, v << shift, 0)
    prefix = jnp.cumsum(contrib)  # inclusive
    # run bit-sum at the start = prefix[end] - prefix[start - 1].  The
    # NEAREST run-end's prefix comes from a reverse cummin instead of a
    # gather (prefix is a nondecreasing cumsum, so the min over run-ends
    # at-or-after p IS the nearest one's value), which replaces a
    # 16M-element prefix[endi] gather
    pend = jnp.flip(jax.lax.cummin(
        jnp.flip(jnp.where(run_end, prefix, jnp.int32(2**31 - 1)))))
    run_len = endi - idx + 1  # valid at run starts
    run_bits = pend - (prefix - contrib)
    overflow = jnp.any(run_start & (run_len > 30))
    run_val = (jnp.int32(1) << jnp.clip(run_len, 0, 30)) | run_bits
    zeros_out = jnp.maximum(run_val - 1, 0)

    # per-input-symbol output contribution: 1 for nonzero syms, run zeros
    # attributed to the run's first bit
    out_len_here = jnp.where(
        valid & (v > 1), 1, jnp.where(run_start, zeros_out, 0)
    )
    pos = jnp.cumsum(out_len_here) - out_len_here  # exclusive scan
    total = jnp.sum(out_len_here)

    out = jnp.zeros(out_cap, jnp.uint8)
    nz = valid & (v > 1)
    out = out.at[jnp.where(nz, pos, out_cap)].set(
        jnp.where(nz, (v - 1).astype(jnp.uint8), 0), mode="drop"
    )
    ok = (total == olen) & ~overflow
    return out, ok


# ---------------------------------------------------------------------------
# SRC rank decode (wide: one lane per chunk)


def rank_setup_core(ranks: jnp.ndarray, freqs: jnp.ndarray):
    """Per-lane decoder state from the rank rows + freq tables.

    ranks: (L, OCAP) uint8; freqs: (L, 256) int32.
    Returns (r2s (L,256) i32, bucket (L,256) i32, bucket_end (L,256) i32,
    unique (L,) i32, sym (L,) i32, ok (L,) bool).
    Replicates rank.cpp:96-123: buckets laid out in descending frequency
    (ties: lowest symbol), r2s seeded from the first rank of each bucket in
    that order, initial sym = r2s[0].
    """
    L = ranks.shape[0]
    syms256 = jnp.arange(256, dtype=jnp.int32)
    # sorted_map order: descending freq, ties by lowest symbol — sort by
    # (-freq, sym); zero-freq symbols sort last (freq>0 first)
    f = freqs.astype(jnp.int32)
    neg = -f
    keys = jnp.broadcast_to(syms256, (L, 256))
    negs, sorted_sym = jax.lax.sort((neg, keys), num_keys=1, is_stable=True)
    sorted_freq = -negs
    # bucket base position per sorted rank = exclusive cumsum of freqs
    base = jnp.cumsum(sorted_freq, axis=1) - sorted_freq
    has = sorted_freq > 0
    # bucket/bucket_end in symbol space
    bucket = jnp.zeros((L, 256), jnp.int32).at[
        jnp.arange(L)[:, None], sorted_sym
    ].set(jnp.where(has, base + 1, 0))
    bucket_end = jnp.zeros((L, 256), jnp.int32).at[
        jnp.arange(L)[:, None], sorted_sym
    ].set(jnp.where(has, base + sorted_freq, 0))
    unique = jnp.sum(has, axis=1).astype(jnp.int32)

    # r2s seeding: in sorted order, r2s[ranks[base]] = sym (later wins).
    # Serial 256-step loop (setup-time only).
    def seed(j, carry):
        r2s = carry
        sym = sorted_sym[:, j]
        b = base[:, j]
        r = ranks[jnp.arange(L), jnp.clip(b, 0, ranks.shape[1] - 1)].astype(jnp.int32)
        ok_j = has[:, j]
        r2s = r2s.at[jnp.arange(L), jnp.where(ok_j, r, 256)].set(
            jnp.where(ok_j, sym, 0), mode="drop"
        )
        return r2s

    r2s = jax.lax.fori_loop(0, 256, seed, jnp.zeros((L, 257), jnp.int32))
    r2s = r2s[:, :256]
    sym0 = r2s[:, 0]
    total = jnp.sum(f, axis=1)
    return r2s, bucket, bucket_end, unique, sym0, total


def rank_decode_core(ranks: jnp.ndarray, freqs: jnp.ndarray,
                     olens: jnp.ndarray, out_cap: int):
    """Wide-lane SRC rank decode: L chunks in lockstep.

    ranks: (L, OCAP) uint8 rank rows (padded); freqs: (L, 256) i32;
    olens: (L,) i32 actual lengths (<= out_cap; <=0 marks padding lanes).
    Returns (out (L, out_cap) uint8, ok (L,) bool).
    """
    L, OCAP = ranks.shape
    l_idx = jnp.arange(L)
    r2s, bucket, bucket_end, unique, sym, total = rank_setup_core(ranks, freqs)
    ok = (total == jnp.maximum(olens, 0))
    # step-major output slab: the per-step emit is then a CONTIGUOUS row
    # dynamic_update_slice instead of an L-strided column write into
    # (L, out_cap); one u8 transpose at the end pays it back
    out = jnp.zeros((out_cap, L), jnp.uint8)
    # r2s holds symbols (< 256): uint8 quarters the (L, 256) stream traffic
    # of the per-step shift/select passes, which dominate this loop's wall
    r2s = r2s.astype(jnp.uint8)
    cols = jnp.arange(256, dtype=jnp.int32)
    # bucket cursors are bounded by the chunk length: under 2^15 the cursor
    # and its end pack into one int32 (cur | end << 16), halving the
    # per-step one-hot bucket-read traffic; the cursor advance is a +1 on
    # the low half (cur <= end <= 32767: never carries into the end field)
    packed = OCAP <= 0x7FFF
    if packed:
        bucket = bucket | (bucket_end << 16)

    def body(i, carry):
        r2s, bucket, unique, sym, out = carry
        active = i < olens
        out = out.at[i].set(jnp.where(active, sym, out[i]))
        # NO per-step gathers or scatters (a (L,) random gather/scatter per
        # step is dearer than a (L, 256) masked pass at wide L): the
        # per-symbol bucket reads are
        # one-hot reductions, the bucket advance is a masked add, and the
        # r2s MTF shift + front insert is one fused select chain.
        oh = cols[None, :] == sym.astype(jnp.int32)[:, None]  # (L, 256)
        if packed:
            pk = jnp.sum(jnp.where(oh, bucket, 0), axis=1)
            cur = pk & 0xFFFF
            end = pk >> 16
        else:
            cur = jnp.sum(jnp.where(oh, bucket, 0), axis=1)
            end = jnp.sum(jnp.where(oh, bucket_end, 0), axis=1)
        has = active & (cur < end)
        rank = ranks[l_idx, jnp.clip(cur, 0, OCAP - 1)].astype(jnp.int32)
        # branch A: bucket has a next rank; branch B: bucket exhausted ->
        # retire the symbol (rank.cpp:133-148)
        do_mtf = has & (rank > 0)
        fall = active & ~has & (unique > 0)
        new_unique = jnp.where(fall, unique - 1, unique)
        m = jnp.maximum(1, new_unique)  # do-while: at least one shift
        shifted = jnp.concatenate([r2s[:, 1:], r2s[:, -1:]], axis=1)
        shift_mask = jnp.where(do_mtf[:, None], cols[None, :] < rank[:, None],
                               fall[:, None] & (cols[None, :] < m[:, None]))
        set_mask = do_mtf[:, None] & (cols[None, :] == rank[:, None])
        r2s = jnp.where(set_mask, sym[:, None],
                        jnp.where(shift_mask, shifted, r2s))
        bucket = bucket + jnp.where(oh & has[:, None], 1, 0)
        new_sym = jnp.where(do_mtf | fall, r2s[:, 0], sym)
        return r2s, bucket, new_unique, new_sym, out

    steps = jnp.minimum(jnp.maximum(jnp.max(olens), 0), out_cap)
    _, _, _, _, out = jax.lax.fori_loop(
        0, steps, body, (r2s, bucket, unique, sym.astype(jnp.uint8), out)
    )
    return out.T, ok | (olens <= 0)


# ---------------------------------------------------------------------------
# LZ77 decode (on-device token parse + vectorized expansion)

from ..format.varint import CONSTANTS as _VARINT_CONSTANTS
from ..format.constants import LZ_MIN_MATCH


def _leb_from(getb, base, q, n):
    """Decode one LEB128-with-carry varint (utils.cpp:73-90) at local byte
    offset q of a token window; getb(k) yields window byte k, base is the
    window's absolute position.  Returns (value, nbytes, bad)."""
    bs = [getb(q + i) for i in range(5)]
    flags = [(b & 0x80) != 0 for b in bs]
    # d = index of the first terminator byte (cap 4: longer is malformed)
    d = jnp.int32(4)
    for i in range(3, -1, -1):
        d = jnp.where(flags[i], jnp.int32(i), d)
    bad = (base + q + d >= n)
    val = jnp.int32(0)
    for i in range(5):
        use = i < d
        val = jnp.where(use, (val << 7) | bs[i], val)
    last = jnp.int32(0)
    for i in range(5):
        last = jnp.where(d == i, bs[i], last)
    val = (val << 7) | (last & 0x7F)
    consts = jnp.asarray((0,) + _VARINT_CONSTANTS, dtype=jnp.int32)
    val = val + consts[jnp.clip(d, 0, 4)]
    bad = bad | ~flags[4] & (d == 4) & False  # d capped at 4 by construction
    return val, d + 1, bad


def lz_parse_core(buf: jnp.ndarray, n, max_tokens: int, out_cap: int):
    """On-device LZ77 token-stream parse (lz77.cpp:678-714 structure).

    Returns per-token arrays (dst, src, lit, off, match) of length
    max_tokens + 1 (the final raw-tail literal is the last used token,
    with off = match = 0), the token count, total output length, and a
    bad flag.  Unused slots have dst = out_cap + 1 so region searches
    fall past them.
    """
    MT = max_tokens + 1
    dst0 = jnp.full(MT, out_cap + 1, jnp.int32)
    z = jnp.zeros(MT, jnp.int32)
    N = buf.shape[0]
    # a token is at most 16 bytes (tag + three 5-byte varints): ONE
    # 16-element vector gather per token fetches the whole window, packed
    # into four LE words below.  (The byte-at-a-time form paid 16 SCALAR
    # gathers per token; a precomputed N-sized window array costs ~4
    # full-array u32 ops per stage — pure waste on the 1-2 token streams
    # the store/dedupe modes produce.)
    b32 = buf.astype(jnp.uint32)
    i16 = jnp.arange(16, dtype=jnp.int32)

    def cond(c):
        pos, out_len, t, d_, s_, l_, o_, m_, done, bad = c
        return ~done & ~bad & (pos < n)

    def body(c):
        pos, out_len, t, d_, s_, l_, o_, m_, done, bad = c
        idx = pos + i16
        b16 = jnp.where(idx < N, b32[jnp.clip(idx, 0, N - 1)], 0)
        w4 = (b16[0::4] | (b16[1::4] << 8) | (b16[2::4] << 16)
              | (b16[3::4] << 24))

        def getb(k):  # token-window byte k (k < 16), elementwise selects
            word = jnp.where(
                k < 4, w4[0], jnp.where(k < 8, w4[1],
                                        jnp.where(k < 12, w4[2], w4[3])))
            return ((word >> ((k & 3) * 8).astype(jnp.uint32))
                    & jnp.uint32(0xFF)).astype(jnp.int32)

        token = getb(jnp.int32(0))
        q = jnp.int32(1)
        off, nb, b1 = _leb_from(getb, pos, q, n)
        q = q + nb
        match = token >> 3
        ext1, nb1, b2 = _leb_from(getb, pos, q, n)
        has_mext = match == 31
        q = jnp.where(has_mext, q + nb1, q)
        match = jnp.where(has_mext, ext1 + 31, match) + LZ_MIN_MATCH
        lit = token & 7
        ext2, nb2, b3 = _leb_from(getb, pos, q, n)
        has_lext = lit == 7
        q = jnp.where(has_lext, q + nb2, q)
        lit = jnp.where(has_lext, ext2 + 7, lit)
        p = pos + q
        bad = bad | b1 | (has_mext & b2) | (has_lext & b3)
        bad = bad | (match < 0) | (lit < 0) | (off < 0) | (t >= MT)
        ts = jnp.clip(t, 0, MT - 1)

        is_end = off == 0
        # end token: the rest of the input is one raw literal
        end_lit = n - p
        rec_lit = jnp.where(is_end, end_lit, lit)
        rec_match = jnp.where(is_end, 0, match)
        new_out = out_len + rec_lit + rec_match
        bad = bad | (new_out > out_cap)
        bad = bad | (~is_end & ((p + lit >= n) | (out_len + lit - off < 0)))
        d_ = d_.at[ts].set(jnp.where(bad, d_[ts], out_len))
        s_ = s_.at[ts].set(p)
        l_ = l_.at[ts].set(rec_lit)
        o_ = o_.at[ts].set(jnp.where(is_end, 0, off))
        m_ = m_.at[ts].set(rec_match)
        pos = jnp.where(is_end, n, p + lit)
        return (pos, jnp.where(bad, out_len, new_out), t + 1,
                d_, s_, l_, o_, m_, is_end, bad)

    init = (jnp.int32(0), jnp.int32(0), jnp.int32(0),
            dst0, z, z, z, z, jnp.bool_(False), jnp.bool_(False))
    pos, out_len, t, d_, s_, l_, o_, m_, done, bad = jax.lax.while_loop(
        cond, body, init)
    # a stream that ran out without the end token is truncated
    bad = bad | (~done & (t > 0) & (pos >= n) & (n > 0))
    return d_, s_, l_, o_, m_, t, out_len, bad


def lz_expand_core(buf: jnp.ndarray, d_, s_, l_, o_, m_, out_len,
                   out_cap: int):
    """Vectorized region fill + pointer-doubling resolve over parsed tokens."""
    MT = d_.shape[0]
    # region boundaries: token j owns literal region at d_[j] and match
    # region at d_[j] + l_[j]; unused slots sit past out_cap.
    # Region assignment via scatter + cumsum: a searchsorted here is
    # log2(2*MT) rounds of out_cap-wide random gathers; one small scatter
    # and a scan do the same.
    starts = jnp.stack([d_, d_ + l_], axis=1).reshape(-1)  # (2*MT,)
    p = jnp.arange(out_cap, dtype=jnp.int32)
    marks = jnp.zeros(out_cap + 1, jnp.int32).at[
        jnp.clip(starts, 0, out_cap)
    ].add(1, mode="drop")[:out_cap]
    r = jnp.cumsum(marks).astype(jnp.int32) - 1
    r = jnp.clip(r, 0, 2 * MT - 1)
    tok = r >> 1
    is_lit = (r & 1) == 0
    src_idx = jnp.clip(s_[tok] + (p - d_[tok]), 0, buf.shape[0] - 1)
    val = jnp.where(is_lit, buf[src_idx], 0).astype(jnp.uint8)
    self_ref = is_lit | (p >= out_len)
    ptr = jnp.where(self_ref, p, p - o_[tok])
    ptr = jnp.clip(ptr, 0, out_cap - 1)

    def resolve(args):
        val, ptr = args

        def cond(c):
            ptr, _ = c
            return jnp.any(ptr != ptr[ptr])

        def body(c):
            ptr, k = c
            return ptr[ptr], k + 1

        ptr, _ = jax.lax.while_loop(cond, body, (ptr, jnp.int32(0)))
        return val[ptr]

    # all-literal streams (m0 on match-free data) already have ptr == p:
    # skip the doubling loop AND the final out_cap-wide gather
    return jax.lax.cond(
        jnp.any(~self_ref), resolve, lambda a: a[0], (val, ptr))


def lz_decode_dyn_core(buf: jnp.ndarray, n, max_tokens: int, out_cap: int):
    """Full on-device LZ77 decode with dynamic input length.
    Returns (out (out_cap,) u8, out_len, ok)."""
    d_, s_, l_, o_, m_, t, out_len, bad = lz_parse_core(
        buf, n, max_tokens, out_cap)

    def fast(_):
        # single end-token stream (store mode, or m0 with no >=256-byte
        # dupes — every bench/text stream): the output is one contiguous
        # literal run, a dynamic_slice — skips the region scatter/cumsum
        # machinery AND its shift-of-iota gather.
        # The lone end token's header is <= 16 bytes, so pad by 16, not
        # out_cap (saves a 2x-out_cap temp per stage)
        pad = max(out_cap + 16 - buf.shape[0], 0)
        sl = jax.lax.dynamic_slice(
            jnp.pad(buf, (0, pad)), (jnp.clip(s_[0], 0, 16),), (out_cap,))
        return jnp.where(jnp.arange(out_cap, dtype=jnp.int32) < out_len,
                         sl, 0)

    def slow(_):
        return lz_expand_core(buf, d_, s_, l_, o_, m_, out_len, out_cap)

    out = jax.lax.cond(t == 1, fast, slow, None)
    return out, out_len, ~bad


# ---------------------------------------------------------------------------
# Filters decode (vectorized per-chunk inverse transforms)

_WEIGHT_RATE = 6  # filters.cpp:44


def filters_decode_dyn_core(buf: jnp.ndarray, m, out_cap: int):
    """Inverse filter stage with dynamic input length m.

    Chunk k's 2-byte (type,width) header sits at k*(FBS+2); payload length
    is min(FBS, m - hdr - 2) (filters.cpp:442-490 semantics).  Returns
    (out (out_cap,) u8, out_len, ok)."""
    N = buf.shape[0]
    FMAX = out_cap // (_FBS + 2) + 2
    k = jnp.arange(FMAX, dtype=jnp.int32)
    hdr = k * (_FBS + 2)
    have = hdr < m
    # chunk k occupies the CONTIGUOUS bytes [k*(FBS+2), (k+1)*(FBS+2)):
    # pad + reshape instead of an (FMAX, FBS) index gather for what is a
    # fixed-stride layout
    need = FMAX * (_FBS + 2)
    bp = (jnp.pad(buf, (0, need - N)) if need > N else buf[:need]).reshape(
        FMAX, _FBS + 2)
    ftype = jnp.where(have, bp[:, 0], 0).astype(jnp.int32)
    width = jnp.where(have, bp[:, 1], 0).astype(jnp.int32)
    plen = jnp.where(have, jnp.minimum(_FBS, m - hdr - 2), 0)
    ok = ~jnp.any(have & ((ftype >= 3) | (width > 32) | (m - hdr < 2)))

    j = jnp.arange(_FBS, dtype=jnp.int32)
    jj = j[None, :]
    inb = jj < plen[:, None]
    C = jnp.where(inb, bp[:, 2:], 0).astype(jnp.int32)  # (FMAX, FBS)

    w = jnp.maximum(width, 1)[:, None]
    L = plen[:, None]

    # ---- types 0/1 (delta / LPC + channel unreorder), gated at block
    # level: a -f0 stream pays neither the cumsum nor the unreorder gather
    def run_01(C):
        # sequential delta over the reordered stream = cumsum
        dec_delta = jnp.cumsum(C, axis=1) & 0xFF

        # LPC serial recurrence, run only when some chunk needs it
        def run_lpc(C):
            def body(i, carry):
                out, weight, p1, p2 = carry
                active = i < plen
                err = C[:, i]
                cur = (weight + (((p1 - p2) + p1) - err)) & 0xFF
                nw = weight + ((err - weight) >> _WEIGHT_RATE)
                out = out.at[:, i].set(jnp.where(active, cur, out[:, i]))
                return (out,
                        jnp.where(active, nw, weight),
                        jnp.where(active, cur, p1),
                        jnp.where(active, p1, p2))

            z = jnp.zeros(FMAX, jnp.int32)
            out0 = jnp.zeros((FMAX, _FBS), jnp.int32)
            lpc_steps = jnp.max(jnp.where((ftype == 1) & (width > 0), plen, 0))
            out, _, _, _ = jax.lax.fori_loop(
                0, lpc_steps, body, (out0, z, z, z))
            return out

        any_lpc = jnp.any(have & (ftype == 1) & (width > 0))
        dec_lpc = jax.lax.cond(any_lpc, run_lpc, lambda C: C, C)

        # unreorder gather: original position p came from reordered index
        # base(p % w) + p // w with base(c) = c*(L//w) + min(c, L%w)
        ch = jj % w
        ro = ch * (L // w) + jnp.minimum(ch, L % w) + jj // w
        ro = jnp.clip(ro, 0, _FBS - 1)
        dec01 = jnp.where(ftype[:, None] == 1, dec_lpc, dec_delta)
        return jnp.take_along_axis(dec01, ro, axis=1)

    any_01 = jnp.any(have & (ftype <= 1) & (width > 0))
    dec01 = jax.lax.cond(any_01, run_01, lambda C: C, C)

    # ---- type 2: inline per-channel delta = stride-w doubling prefix sum
    def run_inline(C):
        align = L % w
        body_mask = jj >= align
        acc = jnp.where(body_mask, C, 0)
        for p2k in range(17):  # 2^17 > FBS
            shift = w << p2k
            can = jj - shift >= align
            idxs = jnp.clip(jj - shift, 0, _FBS - 1)
            add = jnp.where(can, jnp.take_along_axis(acc, idxs, axis=1), 0)
            acc = acc + add
            # early fixpoint is shape-static; 17 rounds is cheap adds
        return jnp.where(body_mask, acc & 0xFF, C)

    any_inline = jnp.any(have & (ftype == 2) & (width > 0))
    dec2 = jax.lax.cond(any_inline, run_inline, lambda C: C, C)

    dec = jnp.where((width[:, None] > 0),
                    jnp.where(ftype[:, None] == 2, dec2, dec01), C)

    # ---- concatenate chunks into the contiguous output.  plen is FBS for
    # every chunk but the last (headers sit at fixed strides), so chunk k's
    # output base is k*FBS by construction: a masked reshape, never a
    # scatter.
    out_len = jnp.sum(plen)
    flat = jnp.where(inb, dec, 0).astype(jnp.uint8).reshape(-1)
    if flat.shape[0] >= out_cap:
        out = flat[:out_cap]
    else:  # unreachable for FMAX = out_cap//(FBS+2)+2; keep a safe path
        out = jnp.pad(flat, (0, out_cap - flat.shape[0]))
    return out, out_len, ok


# ---------------------------------------------------------------------------
# Lpx decode with dynamic length (4-equal-span split + ragged tail slot)

from .lpx_device import _code_span


def lpx_dyn_core(buf: jnp.ndarray, n, out_cap: int, decode: bool,
                 spans: int = 4):
    """Lpx over a dynamic-length stream.  The format split
    (stages.lpx _split_spans) is ceil(n/b) contiguous pieces of
    b = n//spans, the last <= b.  With traced n the kernel's static
    (spans+1)-lane layout covers exactly the streams with
    n % spans <= n // spans — S full pieces plus one ragged tail (and the
    b == 0 tiny degenerate as a single span).  Streams outside that
    regime (more than spans+1 pieces; only reachable when n < spans^2)
    are FLAGGED, not decoded: returns (out, supported) and callers fall
    back to a host engine.  spans = 4 is the reference's format-fixed
    split (lpx.cpp:150-169); JT3 streams carry it as a parameter — span
    count is the intra-block parallel width of this irreducibly serial
    model, so it directly divides the lockstep walk length."""
    S = spans
    b = n // S
    # a main span is <= out_cap//S long and the ragged tail <= b, so
    # out_cap//S (+pad) bounds every row.  The tiny regime (b == 0: one
    # span of n < S bytes) is supported only while n also fits that row —
    # sizing span_cap by S instead made every (S+1, span_cap) array (and
    # the column-strided walk reads) balloon once S > out_cap//S (at
    # spans=8192 on an 8 MB block, a 10x larger walk step)
    span_cap = max(out_cap // S, 4) + 4
    tiny = b == 0
    # the (S+1)-lane layout is exact iff the ragged tail fits one piece
    supported = jnp.where(tiny, n <= span_cap - 4, (n - S * b) <= b)
    starts = jnp.where(
        tiny,
        jnp.zeros(S + 1, jnp.int32),
        jnp.arange(S + 1, dtype=jnp.int32) * b,
    )
    lens = jnp.where(
        tiny,
        jnp.concatenate([jnp.atleast_1d(n), jnp.zeros(S, jnp.int32)]),
        jnp.concatenate([jnp.full(S, b, jnp.int32),
                         jnp.atleast_1d(n - S * b)]),
    )
    # deal: source position i lives in span k = min(i//b, S) at column
    # i - k*b — ONE n-indexed scatter into the padded (S+1, span_cap) grid
    # (a target-indexed gather moves (S+1)*span_cap > n elements instead)
    pos = jnp.arange(buf.shape[0], dtype=jnp.int32)
    k = jnp.where(tiny, 0, jnp.minimum(pos // jnp.maximum(b, 1), S))
    slot = jnp.where(pos < n, k * span_cap + (pos - k * starts[1]),
                     (S + 1) * span_cap)
    spans = jnp.zeros((S + 1) * span_cap + 1, buf.dtype).at[slot].set(
        jnp.where(pos < n, buf, 0), mode="drop")[:-1].reshape(S + 1, span_cap)
    # traced loop bound: span_cap is a static capacity far above the actual
    # span length, which is what we actually have to walk
    bound = jnp.max(lens)
    outs = jax.vmap(
        lambda s, ln: _code_span(s, ln, span_cap, decode, steps=bound)
    )(spans, lens)
    # undeal: dest positions are compact [0, n) — pack (dest << 8 | byte)
    # and sort in place of a scatter; fall back to the scatter
    # when out_cap exceeds the 24-bit pack range
    jj = jnp.arange(span_cap, dtype=jnp.int32)
    # strict <: n can equal out_cap here, and at out_cap == 2^24 the last
    # real dest would collide with the sentinel
    if out_cap < (1 << 24):
        dest = jnp.where(jj[None, :] < lens[:, None],
                         starts[:, None] + jj[None, :], (1 << 24) - 1)
        packed = ((dest.reshape(-1).astype(jnp.uint32) << 8)
                  | outs.reshape(-1).astype(jnp.uint32))
        flat = (jax.lax.sort(packed) & 0xFF).astype(jnp.uint8)
        out = flat[:out_cap] if flat.shape[0] >= out_cap else jnp.pad(
            flat, (0, out_cap - flat.shape[0]))
        # mask the sentinel region: only the first n entries are real
        out = jnp.where(jnp.arange(out_cap) < n, out, 0)
    else:
        flat_pos = jnp.where(jj[None, :] < lens[:, None],
                             starts[:, None] + jj[None, :], out_cap)
        out = jnp.zeros(out_cap + 1, jnp.uint8).at[flat_pos.reshape(-1)].set(
            outs.reshape(-1), mode="drop")[:out_cap]
    return out, supported


# ---------------------------------------------------------------------------
# Inverse BWT with dynamic length

def ibwt_dyn_core(buf: jnp.ndarray, total, units: int, out_cap: int):
    """Inverse BWT over a dynamic-length stage buffer (bwt data + raw tail
    + units anchors).  Returns (out (out_cap,) u8, out_len, ok)."""
    N = buf.shape[0]
    n = total - units * 4
    rem = jnp.where(n > 0, n % units, 0)
    nlen = jnp.maximum(n - rem, 0)
    # little-endian int32 anchors at buf[n + 4u]
    u = jnp.arange(units, dtype=jnp.int32)
    ab = [buf[jnp.clip(n + 4 * u + i, 0, N - 1)].astype(jnp.int32)
          for i in range(4)]
    anchors = ab[0] | (ab[1] << 8) | (ab[2] << 16) | (ab[3] << 24)
    ok = (n >= 0) & jnp.all(
        (anchors >= 1) & (anchors <= jnp.maximum(nlen, 1)) | (nlen == 0))

    pos = jnp.arange(out_cap, dtype=jnp.int32)
    # buf[pos] with pos = iota is a SLICE, not a gather: spell the
    # contiguous read as one
    bv = buf[:out_cap] if N >= out_cap else jnp.pad(buf, (0, out_cap - N))
    keys = jnp.where(pos < nlen, bv.astype(jnp.int32), jnp.int32(0x1FF))
    sorted_keys, order = jax.lax.sort((keys, pos), num_keys=1, is_stable=True)
    idx = anchors[0]
    lf = order + (order >= idx).astype(jnp.int32)
    # combined (lf << 8 | byte) packing overflows once lf can reach 2^24
    # (total <= out_cap implies nlen < out_cap, so out_cap <= 2^24 is safe
    # in uint32); bigger blocks take the split two-gather path
    combined = out_cap <= (1 << 24)
    if combined:
        cmap = (lf.astype(jnp.uint32) << 8) | (sorted_keys & 0xFF).astype(jnp.uint32)
    else:
        sbyte = (sorted_keys & 0xFF).astype(jnp.uint8)

    step = jnp.where(nlen > 0, nlen // units, 0)
    step_cap = out_cap // units + 1
    chunk = jnp.zeros((step_cap, units), jnp.uint8)

    def body(i, carry):
        p, chunk = carry
        j = jnp.clip(p - 1, 0, out_cap - 1)
        if combined:
            c = cmap[j]
            nxt = jnp.clip((c >> 8).astype(jnp.int32), 0, out_cap)
            byte = (c & 0xFF).astype(jnp.uint8)
        else:
            nxt = jnp.clip(lf[j], 0, out_cap)
            byte = sbyte[j]
        chunk = jax.lax.dynamic_update_slice(
            chunk, byte[None, :], (i, 0))
        return nxt, chunk

    p0 = jnp.clip(anchors, 1, jnp.maximum(nlen, 1))
    _, chunk = jax.lax.fori_loop(0, step, body, (p0, chunk))
    # output position i (< nlen) = chunk[i % step, i // step]; raw tail
    # after.  The re-stride is data movement by computed index either way;
    # the combined path packs
    # (dest_pos << 8 | byte) and sorts — chunk slot j = s*units + u maps
    # to dest u*step + s, padding slots sort past out_cap and are masked.
    if combined:
        j = jnp.arange(step_cap * units, dtype=jnp.int32)
        s_j = j // units
        u_j = j - s_j * units
        # sentinel (1<<24)-1: > any real dest (p < nlen < out_cap <= 2^24)
        # and still 24 bits — `out_cap` itself overflows the u32 pack when
        # out_cap == 2^24 exactly (sentinels then sorted FIRST, clobbering
        # the head of the block; caught by the 2^23-boundary test)
        p_j = jnp.where(s_j < step, u_j * step + s_j, (1 << 24) - 1)
        packed = ((p_j.astype(jnp.uint32) << 8)
                  | chunk.reshape(-1).astype(jnp.uint32))
        body_bytes = (jax.lax.sort(packed) & 0xFF).astype(jnp.uint8)
        body_bytes = body_bytes[:out_cap] if body_bytes.shape[0] >= out_cap \
            else jnp.pad(body_bytes, (0, out_cap - body_bytes.shape[0]))
    else:
        s = jnp.where(step > 0, pos % jnp.maximum(step, 1), 0)
        uu = jnp.where(step > 0, pos // jnp.maximum(step, 1), 0)
        body_bytes = chunk.reshape(-1)[
            jnp.clip(s * units + uu, 0, step_cap * units - 1)]
    out = jnp.where(pos < nlen, body_bytes, jnp.where(pos < n, bv, 0))
    return out.astype(jnp.uint8), jnp.maximum(n, 0), ok


# ---------------------------------------------------------------------------
# Fused full-block decode (the device-resident decode chain)

from .rans_wide import decode_lanes_wide


def _decode_lanes(payload, starts, rlens, max_rlen, groups=0):
    """The entropy stage: on a GPU the Pallas kernel that runs each lane
    block's whole symbol loop on chip (rans_pallas.py), elsewhere the
    plain XLA lockstep loop it is checked against."""
    if jax.default_backend() == "gpu":
        from .rans_pallas import decode_lanes_wide_pallas

        return decode_lanes_wide_pallas(payload, starts, rlens,
                                        max_rlen=max_rlen, groups=groups)
    return decode_lanes_wide(payload, starts, rlens, max_rlen=max_rlen,
                             groups=groups)


def decode_block_core(payload: jnp.ndarray, starts: jnp.ndarray,
                      rlens: jnp.ndarray, chunk_olens: jnp.ndarray,
                      chunk_rlens: jnp.ndarray, freqs: jnp.ndarray,
                      lanes: int, units: int, rmax: int, ocap: int,
                      out_cap: int, max_tokens: int, lpx_spans: int = 4):
    """The whole per-block decode chain, device-resident under one jit:

        wide-interleaved rANS -> RLE0 -> SRC rank -> inverse BWT
        -> LZ77 (configured mode) -> Lpx -> filters -> LZ77 (dedupe)

    the device mirror of the reference's per-block Decomp() sequence
    (jampack.cpp:47-58) with every stage running on fixed-capacity
    buffers and traced actual lengths.

    payload: (PCAP,) uint8 padded block payload.
    starts/rlens: (LMAX,) per-chain payload offsets / symbol counts
      (rlens < 0 marks padding chains); for `lanes` >= 2 chunk c owns
      chain rows [c*lanes, (c+1)*lanes).
    chunk_olens/chunk_rlens: (CMAX,) per-chunk byte/symbol counts (0 pad).
    freqs: (CMAX, 256) rank frequency tables.
    Returns (out (out_cap,) uint8, out_len, ok).
    """
    CMAX = chunk_olens.shape[0]

    # ---- 1+2. entropy chains in lockstep, emitted directly in per-chunk
    # undealt layout (chunk c owns chain rows [c*lanes, (c+1)*lanes) and
    # chunk symbol j lives at (row j % lanes, col j // lanes)): the rANS
    # loop writes its per-step slab straight into that layout, so the
    # "lane undeal" costs nothing (no reshape+transpose pass over the
    # symbols)
    if lanes >= 2:
        chunk_syms, eok = _decode_lanes(
            payload, starts, rlens, max_rlen=rmax, groups=CMAX)
    else:
        syms, eok = _decode_lanes(payload, starts, rlens, max_rlen=rmax)
        chunk_syms = syms[:CMAX]

    # ---- 3. RLE0 per chunk
    ranks, rle_ok = jax.vmap(
        lambda s, rl, ol: rle0_decode_core(s, rl, ol, ocap)
    )(chunk_syms, chunk_rlens, chunk_olens)

    # ---- 4. SRC rank decode, all chunks in lockstep
    chunk_bytes, rank_ok = rank_decode_core(ranks, freqs, chunk_olens, ocap)

    # ---- 5. concatenate chunks: when every nonempty chunk starts at
    # c*ocap (i.e. all preceding chunks are exactly full — the common case
    # for uniform-chunk streams) the rows already ARE the contiguous
    # output (rank_decode zero-pads past olen), so a reshape suffices;
    # otherwise one flat scatter (a searchsorted-based gather would take
    # log2(CMAX) rounds of out_cap-wide gathers)
    base = jnp.cumsum(chunk_olens) - chunk_olens
    total = jnp.sum(chunk_olens)
    jj = jnp.arange(ocap, dtype=jnp.int32)[None, :]
    can_reshape = CMAX * ocap >= out_cap  # static
    aligned = jnp.all(
        (base == jnp.arange(CMAX, dtype=jnp.int32) * ocap)
        | (chunk_olens <= 0)
    ) & can_reshape

    def concat_reshape(cb):
        return cb.reshape(-1)[:out_cap]

    def concat_scatter(cb):
        flat_pos = jnp.where(jj < chunk_olens[:, None], base[:, None] + jj,
                             out_cap)
        return jnp.zeros(out_cap + 1, jnp.uint8).at[
            flat_pos.reshape(-1)].set(cb.reshape(-1), mode="drop")[:out_cap]

    if can_reshape:
        stage = jax.lax.cond(aligned, concat_reshape, concat_scatter,
                             chunk_bytes)
    else:
        stage = concat_scatter(chunk_bytes)

    # ---- 6..9. inverse BWT, LZ (mode), Lpx, filters, LZ (dedupe)
    stage, n, ib_ok = ibwt_dyn_core(stage, total, units, out_cap)
    stage, n, lz1_ok = lz_decode_dyn_core(stage, n, max_tokens, out_cap)
    if lpx_spans > 0:
        stage, lpx_sup = lpx_dyn_core(stage, n, out_cap, decode=True,
                                      spans=lpx_spans)
    else:
        # spans == 0: the encoder measured no Lpx gain and skipped the
        # stage (framing.py JT3 ext word) — the decode chain's dominant
        # serial-walk term drops out entirely
        lpx_sup = jnp.bool_(True)
    stage, n, f_ok = filters_decode_dyn_core(stage, n, out_cap)
    out, n, lz0_ok = lz_decode_dyn_core(stage, n, max_tokens, out_cap)

    active = rlens >= 0
    ok = (jnp.all(eok | ~active) & jnp.all(rle_ok | (chunk_olens <= 0))
          & jnp.all(rank_ok) & ib_ok & lz1_ok & f_ok & lz0_ok)
    # lpx_sup False means the stream's span split exceeds the kernel's
    # static lane layout (valid stream, device-unsupported shape): the
    # caller must fall back to a host engine, NOT report corruption
    return out, n, ok, lpx_sup
