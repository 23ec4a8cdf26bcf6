"""Host wrapper for the fused device-resident block encode.

The encode mirror of runtime/device_decode.py: all O(n) data work runs
inside one jitted device program per block (kernels/encode_stages.
encode_block_core — the device counterpart of the reference's per-block
Comp() chain, jampack.cpp:30-42); the host computes the checksum and
splices format *metadata* (chunk headers, lane tables) around the
device-produced payload byte ranges.

Supported configuration: match_finder=3 (LZ store) + filters=0 — the
modes whose stage lengths are static functions of the block size, so the
whole chain compiles with static shapes.  Archives are byte-identical to
every host engine's at the same Options (tests/test_device_pipeline.py).
"""

import numpy as np

from ..format import checksum as _checksum
from ..format.constants import ANS_CHUNK_SIZE
from ..format.varint import encode_leb128
from ..stages.ans import write_chunk_header
from .pipeline import LZ_MODE_STORE, Options


def filter_configs(data: np.ndarray, filters: int, s1: np.ndarray = None):
    """Per-64KB-chunk (type, width) picks for the fused chain's filter
    stage, computed over the stage-1 buffer — the store framing
    [token | data] by default, or an explicit host-LZ output `s1` (the
    filters' actual input either way, jampack.cpp:36-37).  The picks come
    from the device search with host f64 near-tie re-scoring, so they
    match the host engines' exactly.  None for -f0 (passthrough)."""
    if filters == 0:
        return None
    from ..kernels.filters_search import pick_f1_configs, pick_f2_configs

    if s1 is None:
        from ..format.constants import LZ_MIN_MATCH
        from ..stages.lz77 import write_token

        s1 = np.concatenate([
            np.frombuffer(write_token(LZ_MIN_MATCH, LZ_MIN_MATCH, 0),
                          np.uint8),
            np.asarray(data, dtype=np.uint8)])
    picks = (pick_f1_configs if filters == 1 else pick_f2_configs)(s1)
    return np.asarray(picks, dtype=np.int32).reshape(-1, 2)


def _bucket_cap(n: int) -> int:
    """Pow2 capacity bucket: one XLA compile per bucket, not per exact
    block length (ibwt_dyn_core's convention on the decode side)."""
    return max(1 << (max(n, 1) - 1).bit_length(), 1 << 16)


def encode_block_device(data: np.ndarray, opt: Options):
    """Encode one block entirely on device; returns (crc, payload bytes).
    opt.lpx_auto is refused here (the span choice must reach the framing
    word) — use encode_block_device_ex."""
    if getattr(opt, "lpx_auto", False):
        raise ValueError(
            "lpx_auto chooses per-block spans; use encode_block_device_ex")
    crc, payload, _ = encode_block_device_ex(data, opt)
    return crc, payload


def encode_block_device_ex(data: np.ndarray, opt: Options):
    """(crc, payload bytes, lpx_spans_used): the device mirror of
    pipeline.compress_block_ex.  Under opt.lpx_auto the per-block Lpx
    gate runs ON DEVICE inside the fused jit (encode_front_core) with the
    host gate's exact integer arithmetic, so archives stay byte-identical
    to the host encoder's per-block choices.

    Raises NotImplementedError for configurations whose encoders are
    host-only (real LZ match finding) and for blocks below the device
    minimum — callers take the host engines there."""
    import jax
    import jax.numpy as jnp

    from ..format.constants import FILTER_BLOCK_SIZE, LZ_MIN_MATCH
    from ..kernels.encode_stages import _ceil_div, encode_block_dyn_core
    from ..stages.lz77 import write_token

    if opt.match_finder != LZ_MODE_STORE or opt.filters not in (0, 1, 2):
        raise NotImplementedError(
            "device encode supports match_finder=3 (store) + filters 0/1/2")
    data = np.ascontiguousarray(np.asarray(data, dtype=np.uint8))
    n = int(data.size)
    crc = _checksum.integrity_check(data)
    units = int(opt.anchor_units)
    # tiny blocks (no full BWT row per unit) take the host path
    if n < max(4 * units, 1024):
        raise NotImplementedError("block too small for the device chain")
    chunk = min(max(int(opt.ans_chunk), 1), ANS_CHUNK_SIZE)
    lanes = int(opt.rans_lanes)

    spans = int(opt.lpx_spans)
    T = len(write_token(LZ_MIN_MATCH, LZ_MIN_MATCH, 0))
    n2 = (n + T) + 2 * _ceil_div(n + T, FILTER_BLOCK_SIZE)
    cap = _bucket_cap(n)
    f_cap = _ceil_div(cap + T, FILTER_BLOCK_SIZE)
    fc = filter_configs(data, opt.filters)
    if spans > 0:
        b = n2 // spans
        span_cap = max(f_cap * (FILTER_BLOCK_SIZE + 2) // spans, 4) + 4
        unsupported = ((b > 0 and (n2 - spans * b) > b)
                       or (b == 0 and n2 > span_cap - 4))
    else:  # spans == 0: Lpx stage skipped — no span-layout constraint
        unsupported = False
    auto = bool(getattr(opt, "lpx_auto", False))
    if unsupported:
        # Lpx regimes the dyn core's (spans+1, out_cap//spans) layout
        # can't express — many pieces (> spans+1, only when
        # n2 < spans*(spans+1)), a ragged remainder longer than one piece,
        # or a tiny single span longer than the capacity row: take the
        # exact static split (one compile per length, confined to this
        # corner), whose Lpx gate runs on device as well
        from ..kernels.encode_stages import encode_block_core

        bufs, ptrs, oks, freqs, rlens, kept = encode_block_core(
            jnp.asarray(data), None if fc is None else jnp.asarray(fc),
            n=n, units=units, chunk=chunk, lanes=lanes, lpx_spans=spans,
            lpx_auto=auto)
        return crc, _fetch_and_splice(bufs, ptrs, oks, freqs, rlens,
                                      stage4_len(n, units), chunk,
                                      lanes), (spans if bool(kept) else 0)
    padded = np.zeros(cap, dtype=np.uint8)
    padded[:n] = data
    if fc is not None:
        fc_pad = np.zeros((f_cap, 2), dtype=np.int32)
        fc_pad[: fc.shape[0]] = fc
        fc = jnp.asarray(fc_pad)
    bufs, ptrs, oks, freqs, rlens, sup, keep = encode_block_dyn_core(
        jnp.asarray(padded), jnp.int32(n), fc, units=units, chunk=chunk,
        lanes=lanes, lpx_spans=spans, lpx_auto=auto)
    import jax

    flags = np.asarray(jax.device_get(jnp.stack(
        [sup.astype(jnp.int32), keep.astype(jnp.int32)])))
    assert bool(flags[0])  # the static-split branch above covers the rest
    return crc, _fetch_and_splice(bufs, ptrs, oks, freqs, rlens,
                                  stage4_len(n, units), chunk, lanes), \
        (spans if bool(flags[1]) else 0)


_BATCH_ENC_JIT = {}
_JIT_META_PACK = {}


def encode_blocks_device(blocks, opt: Options):
    """Encode B same-length blocks in ONE batched device program on one
    device (the encode counterpart of decode_blocks_device; reference
    analog: the multi-block OpenMP compress loop, jampack.cpp:193-224).
    Same configuration support as encode_block_device; all blocks must
    share a length.  Returns a list of (crc, payload) tuples, each
    byte-identical to encode_block_device on that block."""
    import jax
    import jax.numpy as jnp

    from ..format.constants import FILTER_BLOCK_SIZE, LZ_MIN_MATCH
    from ..kernels.encode_stages import _ceil_div, encode_block_dyn_core
    from ..stages.lz77 import write_token

    if opt.match_finder != LZ_MODE_STORE or opt.filters not in (0, 1, 2):
        raise NotImplementedError(
            "device encode supports match_finder=3 (store) + filters 0/1/2")
    if len({int(np.asarray(b).size) for b in blocks}) != 1:
        raise NotImplementedError("batched encode needs same-length blocks")
    blocks = [np.ascontiguousarray(np.asarray(b, np.uint8)) for b in blocks]
    n = int(blocks[0].size)
    units = int(opt.anchor_units)
    if n < max(4 * units, 1024):
        raise NotImplementedError("block too small for the device chain")
    chunk = min(max(int(opt.ans_chunk), 1), ANS_CHUNK_SIZE)
    lanes = int(opt.rans_lanes)
    spans = int(opt.lpx_spans)
    T = len(write_token(LZ_MIN_MATCH, LZ_MIN_MATCH, 0))
    n2 = (n + T) + 2 * _ceil_div(n + T, FILTER_BLOCK_SIZE)
    cap = _bucket_cap(n)
    f_cap = _ceil_div(cap + T, FILTER_BLOCK_SIZE)
    if spans > 0:
        b2 = n2 // spans
        span_cap = max(f_cap * (FILTER_BLOCK_SIZE + 2) // spans, 4) + 4
        if ((b2 > 0 and (n2 - spans * b2) > b2)
                or (b2 == 0 and n2 > span_cap - 4)):
            raise NotImplementedError(
                "Lpx span layout outside the batched device regime")

    padded = np.zeros((len(blocks), cap), np.uint8)
    for i, blk in enumerate(blocks):
        padded[i, :n] = blk
    fcs = None
    if opt.filters > 0:
        fcs = np.zeros((len(blocks), f_cap, 2), np.int32)
        for i, blk in enumerate(blocks):
            fc = filter_configs(blk, opt.filters)
            fcs[i, : fc.shape[0]] = fc

    auto = bool(getattr(opt, "lpx_auto", False))
    key = (len(blocks), cap, units, chunk, lanes, spans, auto,
           fcs is not None)
    fn = _BATCH_ENC_JIT.get(key)
    if fn is None:
        from functools import partial

        core = partial(encode_block_dyn_core, units=units, chunk=chunk,
                       lanes=lanes, lpx_spans=spans, lpx_auto=auto)

        # lax.scan over the block axis, NOT vmap: scan keeps every
        # per-block sort temp 1-D (a vmapped sa_doubling_dyn_core lays
        # them out (B, cap)) and still amortizes the host dispatch across
        # the batch
        if fcs is not None:
            def fn(d, nn, fc):
                return jax.lax.scan(
                    lambda c, x: (c, core(x[0], x[1], x[2])),
                    None, (d, nn, fc))[1]
        else:
            def fn(d, nn):
                return jax.lax.scan(
                    lambda c, x: (c, core(x[0], x[1], None)),
                    None, (d, nn))[1]
        fn = jax.jit(fn)
        _BATCH_ENC_JIT[key] = fn
    nvec = jnp.full(len(blocks), n, jnp.int32)
    args = (jnp.asarray(padded), nvec) + (
        (jnp.asarray(fcs),) if fcs is not None else ())
    bufs, ptrs, oks, freqs, rlens, sup, keep = fn(*args)
    flags = np.asarray(jax.device_get(jnp.stack(
        [sup.astype(jnp.int32), keep.astype(jnp.int32)], axis=1)))
    assert bool(flags[:, 0].all())
    out = []
    for i, blk in enumerate(blocks):
        crc = _checksum.integrity_check(blk)
        payload = _fetch_and_splice(bufs[i], ptrs[i], oks[i], freqs[i],
                                    rlens[i], stage4_len(n, units), chunk,
                                    lanes)
        out.append((crc, payload, spans if bool(flags[i, 1]) else 0))
    return out


def _fetch_and_splice(bufs, ptrs, oks, freqs, rlens, n4: int, chunk: int,
                      lanes: int) -> bytes:
    """Device-compact the chain payload tails, fetch the live chunks, and
    splice the block payload.  n4 = the entropy stage's ACTUAL input
    length; padding chunks sit past the live ones in chunk-major order
    and are sliced off after compaction."""
    import jax

    from ..kernels.encode_stages import _ceil_div

    eff = max(lanes, 1)
    C = _ceil_div(n4, chunk)
    NL = C * eff
    # compact the per-chain payload tails into one dense byte array ON
    # DEVICE: the (NL, cap) grid is ~5x the real payload, so one device
    # scatter saves ~4x the payload in device-to-host transfer
    blen = int(bufs.shape[1])
    dense = _compact_chains(bufs, ptrs)
    # ONE metadata fetch instead of four (each device_get is its own
    # round trip): concat everything i32 on device, split on host
    import jax.numpy as jnp

    key = ("pk", NL, C)
    packer = _JIT_META_PACK.get(key)
    if packer is None:
        def _pk(p, o, f, r):
            return jnp.concatenate([
                p[:NL].astype(jnp.int32), o[:NL].astype(jnp.int32),
                f[:C].reshape(-1).astype(jnp.int32),
                r[:C].astype(jnp.int32)])
        packer = jax.jit(_pk)
        _JIT_META_PACK[key] = packer
    meta = np.asarray(jax.device_get(packer(ptrs, oks, freqs, rlens)))
    ptrs = meta[:NL]
    oks = meta[NL:2 * NL]
    freqs = meta[2 * NL:2 * NL + C * 256].reshape(C, 256)
    rlens = meta[2 * NL + C * 256:]
    if not bool(oks.all()):
        raise ValueError(
            "model failure (CDF): chunk not encodable in ref-compat mode")
    lens = blen - ptrs.astype(np.int64)
    total = int(lens.sum())
    dense = np.asarray(jax.device_get(dense[:total]))
    return splice_dense(dense, lens, freqs, rlens, n4, chunk, lanes)


def encode_block_device_lz(data: np.ndarray, opt: Options, engine=None):
    """Device encode for the reference's DEFAULT pipeline: the LZ match
    finders (m0 dedupe pre-pass, jampack.cpp:34-36 / lz77.cpp:544-625,
    and the configured stage-4 finder) run on the host — they are serial
    hash-chain walks — while
    filters+Lpx (front) and BWT+entropy (back) run device-resident with
    traced lengths.  Archives are byte-identical to the host engines'.

    Returns (crc, payload bytes)."""
    import jax
    import jax.numpy as jnp

    from ..kernels.encode_stages import encode_back_jit, encode_front_jit

    if opt.match_finder not in (0, 1, 2) or opt.filters not in (0, 1, 2):
        raise NotImplementedError(
            "host-LZ device encode supports match_finder 0/1/2")
    if getattr(opt, "lpx_auto", False):
        # the Lpx gate isn't plumbed through the device front core yet;
        # raising here routes callers (encode_archive_sharded) to the
        # host compress_block_ex fallback, which gates per block correctly
        raise NotImplementedError("lpx_auto: host path gates per block")
    eng = engine
    if eng is None:  # the native match finder; a build failure raises
        from .engines import NativeEngine

        eng = NativeEngine()
    data = np.ascontiguousarray(np.asarray(data, dtype=np.uint8))
    n = int(data.size)
    crc = _checksum.integrity_check(data)
    units = int(opt.anchor_units)
    if n < max(4 * units, 1024):
        raise NotImplementedError("block too small for the device chain")
    chunk = min(max(int(opt.ans_chunk), 1), ANS_CHUNK_SIZE)
    lanes = int(opt.rans_lanes)
    spans = int(opt.lpx_spans)

    # stage 1 (host): m0 dedupe pre-pass
    s1 = np.asarray(eng.lz_encode(data, 0), dtype=np.uint8)
    n1 = int(s1.size)
    cap1 = _bucket_cap(n1)
    pad1 = np.zeros(cap1, dtype=np.uint8)
    pad1[:n1] = s1
    fc = filter_configs(None, opt.filters, s1=s1)
    if fc is not None:
        from ..format.constants import FILTER_BLOCK_SIZE
        from ..kernels.encode_stages import _ceil_div

        f_cap = _ceil_div(cap1, FILTER_BLOCK_SIZE)
        fc_pad = np.zeros((f_cap, 2), dtype=np.int32)
        fc_pad[: fc.shape[0]] = fc
        fc = jnp.asarray(fc_pad)
    # stages 2+3 (device): filters + Lpx
    s2, n2, sup, _keep = encode_front_jit(jnp.asarray(pad1), jnp.int32(n1),
                                          fc, lpx_spans=spans)
    if not bool(sup):
        raise NotImplementedError(
            "Lpx span layout outside the device regime (tiny block)")
    n2 = int(n2)
    s2_host = np.asarray(jax.device_get(s2[:n2]))
    # stage 4 (host): the configured match finder on the Lpx output
    s3 = np.asarray(eng.lz_encode(s2_host, opt.match_finder), dtype=np.uint8)
    n3 = int(s3.size)
    cap3 = _bucket_cap(n3)
    if n3 < max(4 * units, 1024):
        raise NotImplementedError("stage-4 stream too small for the device "
                                  "chain")
    pad3 = np.zeros(cap3, dtype=np.uint8)
    pad3[:n3] = s3
    # stages 5+6 (device): forward BWT + anchors + entropy
    bufs, ptrs, oks, freqs, rlens = encode_back_jit(
        jnp.asarray(pad3), jnp.int32(n3), units=units, chunk=chunk,
        lanes=lanes)
    return crc, _fetch_and_splice(bufs, ptrs, oks, freqs, rlens,
                                  n3 + 4 * units, chunk, lanes)


def _compact_chains_impl(bufs, ptrs):
    """Scatter every chain's payload tail bufs[i, ptrs[i]:] into a dense
    byte array at exclusive-cumsum offsets (device-side; one scatter)."""
    import jax.numpy as jnp

    NL, cap = bufs.shape
    lens = cap - ptrs
    offs = jnp.cumsum(lens) - lens
    col = jnp.arange(cap, dtype=ptrs.dtype)[None, :]
    valid = col >= ptrs[:, None]
    dst = jnp.where(valid, offs[:, None] + (col - ptrs[:, None]), NL * cap)
    return jnp.zeros(NL * cap + 1, jnp.uint8).at[dst.reshape(-1)].set(
        jnp.where(valid, bufs, 0).reshape(-1), mode="drop")[:-1]


_COMPACT_CACHE = {}


def _compact_chains(bufs, ptrs):
    import jax

    fn = _COMPACT_CACHE.get("fn")
    if fn is None:
        fn = _COMPACT_CACHE["fn"] = jax.jit(_compact_chains_impl)
    return fn(bufs, ptrs)


def stage4_len(n: int, units: int) -> int:
    """Entropy-stage input length for a block of n raw bytes in the
    store/filters-off configuration (the same static math as the core)."""
    from ..format.constants import FILTER_BLOCK_SIZE, LZ_MIN_MATCH
    from ..kernels.encode_stages import _ceil_div
    from ..stages.lz77 import write_token

    T = len(write_token(LZ_MIN_MATCH, LZ_MIN_MATCH, 0))
    n1 = n + T
    n2 = n1 + 2 * _ceil_div(n1, FILTER_BLOCK_SIZE)
    return n2 + T + 4 * units


def splice_payload(bufs, ptrs, freqs, rlens, n4: int, chunk: int,
                   lanes: int) -> bytes:
    """Assemble one block's payload from the core's padded (NL, cap)
    outputs (host arrays) — concatenates the chain tails and delegates to
    splice_dense.  n4 = the entropy stage's actual input length."""
    lens = bufs.shape[1] - np.asarray(ptrs, dtype=np.int64)
    dense = np.concatenate(
        [bufs[i, int(ptrs[i]):] for i in range(bufs.shape[0])])
    return splice_dense(dense, lens, freqs, rlens, n4, chunk, lanes)


def splice_dense(dense, lens, freqs, rlens, n4: int, chunk: int,
                 lanes: int) -> bytes:
    """Assemble one block's payload from densely packed chain payloads
    (chain i's bytes at [offs[i], offs[i]+lens[i]), offs = exclusive
    cumsum): per chunk, header + (lane table +) chain payloads — the same
    format path as stages/ans.py ans_encode / jn_ans.cpp."""
    from ..kernels.encode_stages import _ceil_div

    eff = max(lanes, 1)
    C = rlens.size
    assert C == _ceil_div(n4, chunk)
    offs = np.concatenate([[0], np.cumsum(lens)])
    out = bytearray()
    for c in range(C):
        olen = min(chunk, n4 - chunk * c)
        i0 = c * eff
        if lanes >= 2:
            table = b"".join(encode_leb128(int(lens[i0 + l]))
                             for l in range(eff))
            body = table + dense[offs[i0]:offs[i0 + eff]].tobytes()
        else:
            body = dense[offs[i0]:offs[i0 + 1]].tobytes()
        out += write_chunk_header(freqs[c], olen, len(body), int(rlens[c]))
        out += body
    return bytes(out)
