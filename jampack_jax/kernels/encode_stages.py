"""Device-resident encode-stage kernels with dynamic lengths.

The encode mirrors of kernels/device_stages.py: every core is jittable
with traced actual lengths and static capacity bounds so the full encode
chain — LZ store framing -> filters -> Lpx -> forward BWT -> SRC rank ->
RLE0 -> wide rANS — can run device-resident under one jit (and under
shard_map across a mesh).  Each kernel is bit-exact with its executable-
spec counterpart in stages/.

* RLE0 encode (rle.cpp:22-47): fully vectorized.  Zero runs are segmented
  with flip-cummin / cummax passes; a run of R zeros emits the binary
  expansion of R+1 minus its leading bit — the j-th emitted bit is
  attributed to the run's j-th zero, so ONE drop-mode scatter lays out the
  whole 16-bit symbol stream.
* SRC rank encode (rank.cpp:45-90): irreducibly serial per chunk (the MTF
  list is data-dependent), decoded here as a lane axis in lockstep like
  rank_decode_core.  The bucketed output layout is produced WITHOUT
  per-step scatters: each step emits (bucket_pos << 8 | rank) packed into
  its own column, and one per-lane sort at the end delivers the bucket
  order (a sort by a permutation key in place of a scatter).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def rle0_encode_core(data: jnp.ndarray, n, rcap: int):
    """data: (N,) uint8 padded; n traced actual length.
    Returns (syms (rcap,) uint16, rlen).  rlen <= n always (zero runs
    shrink, nonzero symbols map 1:1), so rcap = N suffices."""
    N = data.shape[0]
    idx = jnp.arange(N, dtype=jnp.int32)
    valid = idx < n
    v = data.astype(jnp.int32)
    z = valid & (v == 0)
    prev_z = jnp.concatenate([jnp.zeros(1, bool), z[:-1]])
    next_z = jnp.concatenate([z[1:], jnp.zeros(1, bool)])
    run_start = z & ~prev_z
    run_end = z & ~next_z
    # run bounds at every zero position: nearest end at/after (reverse
    # cummin) and nearest start at/before (cummax)
    endi = jnp.flip(jax.lax.cummin(
        jnp.flip(jnp.where(run_end, idx, jnp.int32(N)))))
    starti = jax.lax.cummax(jnp.where(run_start, idx, jnp.int32(-1)))
    lv = endi - starti + 2  # L = run + 1 (>= 2 at zero positions)
    # msb = bit_length(L) - 1; chunk lengths are < 2^24
    msb = jnp.zeros(N, jnp.int32)
    for k in range(1, 25):
        msb = msb + (lv >= (1 << k))
    j = idx - starti
    emit_bit = z & (j < msb)
    nonzero = valid & (v > 0)
    emit = nonzero | emit_bit
    cnt = emit.astype(jnp.int32)
    pos = jnp.cumsum(cnt) - cnt
    rlen = jnp.sum(cnt)
    shift = jnp.clip(msb - 1 - j, 0, 31)
    bit = (lv >> shift) & 1
    val = jnp.where(nonzero, v + 1, bit).astype(jnp.uint16)
    out = jnp.zeros(rcap + 1, jnp.uint16).at[
        jnp.where(emit, jnp.minimum(pos, rcap), rcap)
    ].set(jnp.where(emit, val, 0), mode="drop")[:rcap]
    return out, rlen


def rank_encode_core(chunks: jnp.ndarray, olens: jnp.ndarray):
    """Wide-lane SRC rank encode: L chunks in lockstep.

    chunks: (L, OCAP) uint8 (padded); olens: (L,) i32 actual lengths
    (<= OCAP; <= 0 marks padding lanes).
    Returns (ranks (L, OCAP) uint8, freqs (L, 256) i32).
    """
    L, OCAP = chunks.shape
    cols = jnp.arange(256, dtype=jnp.int32)
    idx = jnp.arange(OCAP, dtype=jnp.int32)
    lane = jnp.arange(L, dtype=jnp.int32)[:, None]
    valid = idx[None, :] < olens[:, None]
    c32 = chunks.astype(jnp.int32)
    tgt = jnp.where(valid, c32, 256)  # padding -> overflow bin

    freqs = jnp.zeros((L, 257), jnp.int32).at[
        jnp.broadcast_to(lane, (L, OCAP)), tgt].add(1)[:, :256]

    # MTF list initialised by first-appearance order (rank.cpp:45-51);
    # never-appearing symbols land at the tail — their order is irrelevant
    # (MTF ranks of seen symbols always stay below the unique count)
    first = jnp.full((L, 257), OCAP, jnp.int32).at[
        jnp.broadcast_to(lane, (L, OCAP)), tgt
    ].min(jnp.broadcast_to(idx[None, :], (L, OCAP)))[:, :256]
    _, sym_s = jax.lax.sort(
        (first, jnp.broadcast_to(cols, (L, 256))), num_keys=1, is_stable=True)
    r2s = sym_s.astype(jnp.uint8)

    # bucket bases laid out in descending frequency (ties: lowest symbol),
    # rank.cpp:15-39 + 54-58
    negs, sorted_sym = jax.lax.sort(
        (-freqs, jnp.broadcast_to(cols, (L, 256))), num_keys=1,
        is_stable=True)
    sorted_freq = -negs
    base = jnp.cumsum(sorted_freq, axis=1) - sorted_freq
    has = sorted_freq > 0
    bucket = jnp.zeros((L, 256), jnp.int32).at[
        jnp.broadcast_to(lane, (L, 256)), sorted_sym
    ].set(jnp.where(has, base, 0))

    # step-major output slab: a contiguous row write per step and one
    # transpose at the end instead of OCAP L-strided column writes (as in
    # rank_decode_core); the per-step input reads are rows of the
    # transposed chunks too
    out = jnp.full((OCAP, L), jnp.uint32(0xFFFFFFFF))
    chunks_t = chunks.T

    def body(i, carry):
        r2s, bucket, out = carry
        active = i < olens
        sym = chunks_t[i]
        oh = cols[None, :] == sym.astype(jnp.int32)[:, None]  # (L, 256)
        # NO per-step gathers or scatters (the same trade as
        # rank_decode_core): rank and bucket position are one-hot
        # reductions, the MTF shift is a fused select chain
        rank = jnp.sum(
            jnp.where(r2s == sym[:, None], cols[None, :], 0), axis=1)
        bpos = jnp.sum(jnp.where(oh, bucket, 0), axis=1)
        bucket = bucket + jnp.where(oh & active[:, None], 1, 0)
        packed = jnp.where(
            active,
            (bpos.astype(jnp.uint32) << 8) | rank.astype(jnp.uint32),
            jnp.uint32(0xFFFFFFFF))
        out = out.at[i].set(packed)
        # move-to-front: entries [1, rank] take their left neighbour,
        # entry 0 takes sym (rank.cpp:66-73; rank == 0 is a no-op)
        shifted = jnp.concatenate([r2s[:, :1], r2s[:, :-1]], axis=1)
        take = active[:, None] & (cols[None, :] <= rank[:, None]) \
            & (cols[None, :] >= 1)
        head = active[:, None] & (cols[None, :] == 0)
        r2s = jnp.where(head, sym[:, None], jnp.where(take, shifted, r2s))
        return r2s, bucket, out

    steps = jnp.minimum(jnp.maximum(jnp.max(olens), 0), OCAP)
    _, _, out = jax.lax.fori_loop(0, steps, body, (r2s, bucket, out))
    out = out.T
    # the bucketed layout = ranks ordered by their packed positions; the
    # 0xFFFFFFFF padding sentinels sort last and are masked off
    ordered = jax.lax.sort(out, dimension=1)
    ranks = jnp.where(valid, (ordered & 0xFF).astype(jnp.uint8), 0)
    return ranks, freqs


# ---------------------------------------------------------------------------
# Fused full-block encode (the device-resident encode chain)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _filters_apply_rows(rows, plens, ftype, width):
    """Apply the picked filter config to every 64 KB chunk row in lockstep
    (filters.cpp:21-142 encode direction; configs come from the device
    search, kernels/filters_search.py).

    rows: (F, FBS) uint8; plens/ftype/width: (F,) i32.
    Returns the transformed (F, FBS) uint8 payload rows."""
    from .filters_search import _lpc_all, _reorder_idx

    F, FBS = rows.shape
    r32 = rows.astype(jnp.int32)
    w = jnp.maximum(width, 1)
    j = jnp.arange(FBS, dtype=jnp.int32)[None, :]
    inb = j < plens[:, None]

    # types 0/1 transform the channel-reordered stream (and store it
    # reordered); the decode side un-reorders after the inverse transform
    ro = jax.vmap(_reorder_idx)(plens, w)
    reordered = jnp.where(inb, jnp.take_along_axis(r32, ro, axis=1), 0)
    shifted = jnp.concatenate(
        [jnp.zeros((F, 1), jnp.int32), reordered[:, :-1]], axis=1)
    delta = (reordered - shifted) & 0xFF

    any_lpc = jnp.any((ftype == 1) & (width > 0))
    lpc = jax.lax.cond(
        any_lpc, lambda r: _lpc_all(r, plens), lambda r: r, reordered)

    # type 2: per-channel delta in place, head [0, align + w) kept raw
    align = plens % w
    src = jnp.clip(j - w[:, None], 0, FBS - 1)
    can = (j - w[:, None]) >= align[:, None]
    prev = jnp.take_along_axis(r32, src, axis=1)
    inline = (r32 - jnp.where(can, prev, 0)) & 0xFF

    out = jnp.where(ftype[:, None] == 2, inline,
                    jnp.where(ftype[:, None] == 1, lpc, delta))
    out = jnp.where(width[:, None] > 0, out, r32)
    return jnp.where(inb, out, 0).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("n", "units", "chunk", "lanes",
                                   "lpx_spans", "lpx_auto"))
def encode_block_core(data: jnp.ndarray, fconfigs=None, *, n: int,
                      units: int, chunk: int, lanes: int, lpx_spans: int,
                      lpx_auto: bool = False):
    """The whole per-block ENCODE chain, device-resident under one jit:

        LZ store framing -> filters -> Lpx -> LZ store framing
        -> forward BWT + anchors -> per chunk: SRC rank -> RLE0
        -> per chain: model pass -> reverse interleaved rANS

    the device mirror of the reference's per-block Comp() sequence
    (jampack.cpp:30-42) in the store configuration, where every stage
    length is a static function of the block length `n` — filter output
    is config-independent in length, so this holds for -f0/-f1/-f2 alike
    and the whole chain compiles with static shapes (one jit variant per
    distinct block size; archives keep it constant except the ragged
    tail).

    data: (n,) uint8.  fconfigs: None for -f0 passthrough, else the
    (F, 2) i32 per-chunk (type, width) picks from the device filter
    search.  Returns (bufs (NL, 4*max_rlen+16) u8 payload buffers,
    ptrs (NL,), oks (NL,), freqs (C, 256) i32, rlens (C,), lpx_kept)
    for the host splicer — NL = C * max(lanes, 1) chains in chunk-major
    order.  lpx_auto runs the per-block Lpx gate on device with the host
    gate's exact integer arithmetic (see encode_front_core); lpx_kept
    False means frame the block with spans=0.
    """
    from ..format.constants import FILTER_BLOCK_SIZE, LZ_MIN_MATCH
    from ..stages.lz77 import write_token
    from .rans_encode import rans_reverse_encode_wide
    from .sa import bwt_from_prev_sorted, sa_doubling_core

    tok = np.frombuffer(write_token(LZ_MIN_MATCH, LZ_MIN_MATCH, 0),
                        dtype=np.uint8)
    T = tok.size
    tokj = jnp.asarray(tok)
    FBS = FILTER_BLOCK_SIZE

    # ---- 1. LZ store + 2. filters: deal [token | data] into 64 KB chunk
    # rows, transform each by its picked config (passthrough for -f0), and
    # emit the 2-byte (type, width) headers inline — a reshape/concat, no
    # scatter (headers sit at fixed strides, filters.cpp:416-427)
    n1 = n + T
    nf = _ceil_div(n1, FBS)
    n2 = n1 + 2 * nf
    s1 = jnp.concatenate([tokj, data])
    rows1 = jnp.zeros(nf * FBS, jnp.uint8).at[: n1].set(s1).reshape(nf, FBS)
    plens = jnp.asarray(
        np.minimum(FBS, n1 - FBS * np.arange(nf)).astype(np.int32))
    if fconfigs is None:
        hdr = jnp.zeros((nf, 2), jnp.uint8)
        payload_rows = rows1
    else:
        ftype = fconfigs[:, 0]
        width = fconfigs[:, 1]
        payload_rows = _filters_apply_rows(rows1, plens, ftype, width)
        hdr = jnp.stack(
            [jnp.where(width > 0, ftype, 0), width], axis=1).astype(jnp.uint8)
    s2 = jnp.concatenate([hdr, payload_rows], axis=1).reshape(-1)[:n2]

    # ---- 3. Lpx (span-parallel XOR prediction), same-size.  The split is
    # _split_spans(n2, spans): ceil(n2/b) contiguous pieces of b = n2//S
    # (the last <= b) — with static n2 that is a plain reshape, every
    # piece coded in lockstep (no deal/undeal scatters at all)
    from ..stages.lpx import _split_spans
    from .lpx_device import _code_span

    sp = _split_spans(n2, lpx_spans) if lpx_spans > 0 else []
    if sp:
        R = len(sp)
        bspan = sp[0][1]
        lens = jnp.asarray(np.asarray([ln for _, ln in sp], np.int32))
        rows2 = jnp.zeros(R * bspan, jnp.uint8).at[: n2].set(s2).reshape(
            R, bspan)
        coded = jax.vmap(
            lambda s, ln: _code_span(s, ln, bspan, False))(rows2, lens)
        s2l = coded.reshape(-1)[:n2]
        if lpx_auto:
            # per-block gate, same integer compare as the host encoder
            # (pipeline._lpx_gain_gate) — see encode_front_core
            from ..runtime.pipeline import (LPX_AUTO_GAIN_DEN,
                                            LPX_AUTO_GAIN_NUM)

            gained = (jnp.sum((s2l == 0).astype(jnp.int32))
                      - jnp.sum((s2 == 0).astype(jnp.int32)))
            lpx_kept = (gained * LPX_AUTO_GAIN_DEN
                        >= jnp.int32(n2) * LPX_AUTO_GAIN_NUM)
            s2 = jnp.where(lpx_kept, s2l, s2)
        else:
            s2 = s2l
            lpx_kept = jnp.bool_(True)
    else:
        lpx_kept = jnp.bool_(False)

    # ---- 4. second LZ store framing
    s3 = jnp.concatenate([tokj, s2])
    n3 = n2 + T

    # ---- 5. forward BWT: trailing n3 % units bytes raw, anchors appended
    rem = n3 % units
    nlen = n3 - rem
    _, isa, prev_sorted = sa_doubling_core(s3[:nlen], nlen)
    bwt = bwt_from_prev_sorted(prev_sorted, isa[0], nlen)
    step = nlen // units
    anchors = isa[: units * step : step] + 1  # ISA[u*step]+1, bwt.cpp:44-48
    abytes = ((anchors[:, None] >> jnp.asarray([0, 8, 16, 24])[None, :])
              & 0xFF).astype(jnp.uint8).reshape(-1)
    s4 = jnp.concatenate([bwt, s3[nlen:], abytes])
    n4 = n3 + 4 * units

    # ---- 6. entropy, all chunks in lockstep: rank -> RLE0 -> lane deal
    C = _ceil_div(n4, chunk)
    olens = np.minimum(chunk, n4 - chunk * np.arange(C)).astype(np.int32)
    rows = jnp.zeros(C * chunk, jnp.uint8).at[: n4].set(s4).reshape(C, chunk)
    olens_j = jnp.asarray(olens)
    ranks, freqs = rank_encode_core(rows, olens_j)
    syms, rlens = jax.vmap(
        lambda r, ol: rle0_encode_core(r, ol, chunk))(ranks, olens_j)

    # round-robin lane deal (ans.cpp chunk layout / JTX wide-interleave):
    # chain (c, l) owns chunk c's symbols at positions l, l+lanes, ...
    eff = max(lanes, 1)
    rcap = _ceil_div(chunk, eff) * eff
    max_rlen = rcap // eff
    syms_p = jnp.pad(syms, ((0, 0), (0, rcap - chunk)))
    chains = syms_p.reshape(C, max_rlen, eff).transpose(0, 2, 1).reshape(
        C * eff, max_rlen)
    lane_ids = jnp.arange(eff, dtype=jnp.int32)[None, :]
    crlens = ((rlens[:, None] - lane_ids + eff - 1) // eff).reshape(-1)

    # ---- 7. wide model pass (all chains in one lockstep bank loop) +
    # wide lockstep reverse 4-state rANS (hand-widened rather than a vmap
    # over batched trip counts — rans_encode.py docstring)
    lows, fqs2, oks = _model_pairs(chains, crlens, max_rlen)
    bufs, ptrs = rans_reverse_encode_wide(lows, fqs2, crlens, max_rlen)
    return bufs, ptrs, oks, freqs, rlens, lpx_kept


def _model_pairs(chains, crlens, max_rlen):
    """The encode model pass: on a GPU the Pallas kernel that runs each
    lane block's whole symbol loop on chip (rans_pallas.py), elsewhere the
    plain XLA lockstep loop it is checked against."""
    from .rans_wide import model_pairs_wide

    if jax.default_backend() == "gpu":
        from .rans_pallas import model_pairs_wide_pallas

        return model_pairs_wide_pallas(chains, crlens, max_rlen)
    return model_pairs_wide(chains, crlens, max_rlen)


# ---------------------------------------------------------------------------
# Dynamic-length encode chain: one compile per pow2 capacity bucket
# (the encode mirror of ibwt_dyn_core's pattern),
# split into a FRONT (filters + Lpx) and BACK (BWT + entropy) core so a
# host LZ match finder can run between them for default-mode archives
# (m0 dedupe, lz77.cpp:544-625).


def _entropy_dyn(s4, n4, *, chunk: int, lanes: int):
    """Stage 6+7 with traced n4: rank -> RLE0 -> lane deal -> wide model
    pass -> reverse rANS.  s4: (cap4,) u8 zero-padded past n4."""
    from .rans_encode import rans_reverse_encode_wide

    cap4 = s4.shape[0]
    C = _ceil_div(cap4, chunk)
    olens = jnp.clip(n4 - chunk * jnp.arange(C, dtype=jnp.int32), 0, chunk)
    rows = jnp.pad(s4, (0, C * chunk - cap4)).reshape(C, chunk)
    ranks, freqs = rank_encode_core(rows, olens)
    syms, rlens = jax.vmap(
        lambda r, ol: rle0_encode_core(r, ol, chunk))(ranks, olens)

    eff = max(lanes, 1)
    rcap = _ceil_div(chunk, eff) * eff
    max_rlen = rcap // eff
    syms_p = jnp.pad(syms, ((0, 0), (0, rcap - chunk)))
    chains = syms_p.reshape(C, max_rlen, eff).transpose(0, 2, 1).reshape(
        C * eff, max_rlen)
    lane_ids = jnp.arange(eff, dtype=jnp.int32)[None, :]
    crlens = ((rlens[:, None] - lane_ids + eff - 1) // eff).reshape(-1)
    crlens = jnp.maximum(crlens, 0)

    lows, fqs2, oks = _model_pairs(chains, crlens, max_rlen)
    bufs, ptrs = rans_reverse_encode_wide(lows, fqs2, crlens, max_rlen)
    return bufs, ptrs, oks, freqs, rlens


def encode_front_core(s1: jnp.ndarray, n1, fconfigs, *, lpx_spans: int,
                      lpx_auto: bool = False):
    """Filters + Lpx over a traced-length stage-1 buffer (the host-framed
    [LZ tokens]): returns (s2 (cap2,) u8 zero-padded, n2, supported,
    lpx_kept).

    s1: (cap1,) u8 zero-padded past n1.  fconfigs: None (-f0 passthrough)
    or (F_cap, 2) i32 picks, zeros past the actual chunk count.

    lpx_auto runs the per-block Lpx gate ON DEVICE with the exact integer
    arithmetic the host gate uses (pipeline._lpx_gain_gate): the stage
    output is kept only when it zeroes >= NUM/DEN of the bytes; otherwise
    the pre-Lpx buffer passes through and lpx_kept = False (callers frame
    the block with spans=0)."""
    from ..format.constants import FILTER_BLOCK_SIZE

    FBS = FILTER_BLOCK_SIZE
    cap1 = s1.shape[0]
    F = _ceil_div(cap1, FBS)
    rows1 = jnp.pad(s1, (0, F * FBS - cap1)).reshape(F, FBS)
    plens = jnp.clip(n1 - FBS * jnp.arange(F, dtype=jnp.int32), 0, FBS)
    if fconfigs is None:
        hdr = jnp.zeros((F, 2), jnp.uint8)
        payload_rows = rows1
    else:
        ftype = fconfigs[:, 0]
        width = fconfigs[:, 1]
        payload_rows = _filters_apply_rows(rows1, plens, ftype, width)
        hdr = jnp.stack(
            [jnp.where(width > 0, ftype, 0), width], axis=1).astype(jnp.uint8)
        hdr = jnp.where(plens[:, None] > 0, hdr, 0)
    # row i of [hdr | payload] sits at flat [i*(FBS+2), (i+1)*(FBS+2));
    # only the LAST live row is partial, so the flat stream's first n2
    # bytes are the stage output and everything past is zero already
    s2 = jnp.concatenate([hdr, payload_rows], axis=1).reshape(-1)
    nf = (n1 + FBS - 1) // FBS
    n2 = n1 + 2 * nf

    if lpx_spans > 0:
        from .device_stages import lpx_dyn_core

        s2l, sup = lpx_dyn_core(s2, n2, s2.shape[0], decode=False,
                                spans=lpx_spans)
        if lpx_auto:
            from ..runtime.pipeline import (LPX_AUTO_GAIN_DEN,
                                            LPX_AUTO_GAIN_NUM)

            live = jnp.arange(s2.shape[0], dtype=jnp.int32) < n2
            gained = (jnp.sum(((s2l == 0) & live).astype(jnp.int32))
                      - jnp.sum(((s2 == 0) & live).astype(jnp.int32)))
            # n2 < 2^24 and gained <= n2, so gained*DEN stays in int32
            keep = gained * LPX_AUTO_GAIN_DEN >= n2 * LPX_AUTO_GAIN_NUM
            s2 = jnp.where(keep, s2l, s2)
            # a skipped stage has no span-layout constraint
            sup = sup | jnp.logical_not(keep)
        else:
            s2 = s2l
            keep = jnp.bool_(True)
    else:
        # spans == 0: Lpx stage skipped for this block (framing.py)
        sup = jnp.bool_(True)
        keep = jnp.bool_(False)
    return s2, n2, sup, keep


def encode_back_core(s3: jnp.ndarray, n3, *, units: int, chunk: int,
                     lanes: int):
    """Forward BWT (+ anchors) + entropy over a traced-length stage-3
    buffer.  s3: (cap3,) u8 zero-padded past n3.  Returns the same
    (bufs, ptrs, oks, freqs, rlens) layout as encode_block_core with
    capacity-sized leading dims; callers slice the live chunks."""
    from .sa import bwt_from_prev_sorted, sa_doubling_dyn_core

    cap3 = s3.shape[0]
    pos = jnp.arange(cap3 + 4 * units, dtype=jnp.int32)
    rem = n3 % units
    nlen = n3 - rem
    order, isa, prev_sorted = sa_doubling_dyn_core(s3, nlen)
    bwt = bwt_from_prev_sorted(prev_sorted, isa[0], cap3)
    step = nlen // units
    u = jnp.arange(units, dtype=jnp.int32)
    anchors = isa[jnp.clip(u * step, 0, cap3 - 1)] + 1
    abytes = ((anchors[:, None] >> jnp.asarray([0, 8, 16, 24])[None, :])
              & 0xFF).astype(jnp.uint8).reshape(-1)
    s4 = jnp.where(pos[:cap3] < nlen, bwt, s3)
    s4 = jnp.pad(s4, (0, 4 * units))
    s4 = jax.lax.dynamic_update_slice(s4, abytes, (n3,))
    n4 = n3 + 4 * units
    s4 = jnp.where(pos < n4, s4, 0)
    return _entropy_dyn(s4, n4, chunk=chunk, lanes=lanes)


encode_front_jit = partial(jax.jit, static_argnames=("lpx_spans",
                                                     "lpx_auto"))(
    encode_front_core)
encode_back_jit = partial(jax.jit, static_argnames=("units", "chunk",
                                                    "lanes"))(
    encode_back_core)


@partial(jax.jit, static_argnames=("units", "chunk", "lanes", "lpx_spans",
                                   "lpx_auto"))
def encode_block_dyn_core(data: jnp.ndarray, n, fconfigs=None, *,
                          units: int, chunk: int, lanes: int,
                          lpx_spans: int, lpx_auto: bool = False):
    """encode_block_core with a TRACED block length over a static pow2
    capacity: the m3-store chain (both LZ stages emit the bare end
    token), compiled once per (capacity, stream-params) bucket.

    data: (cap,) u8 zero-padded past n.  Returns encode_block_core's
    tuple plus the Lpx `supported` and `lpx_kept` flags (lpx_kept False
    when lpx_auto gated the stage off — frame the block with spans=0)."""
    from ..format.constants import LZ_MIN_MATCH
    from ..stages.lz77 import write_token

    tok = np.frombuffer(write_token(LZ_MIN_MATCH, LZ_MIN_MATCH, 0),
                        dtype=np.uint8)
    tokj = jnp.asarray(tok)
    s1 = jnp.concatenate([tokj, data])
    s2, n2, sup, keep = encode_front_core(s1, n + tok.size, fconfigs,
                                          lpx_spans=lpx_spans,
                                          lpx_auto=lpx_auto)
    s3 = jnp.concatenate([tokj, s2])
    outs = encode_back_core(s3, n2 + tok.size, units=units, chunk=chunk,
                            lanes=lanes)
    return outs + (sup, keep)
