"""Host wrapper for the fused device-resident block decode.

The host touches only format *metadata* — chunk headers, lane tables —
which it already holds (the entropy stage is the first decode stage, so
its input is the raw archive payload).  All O(n) data work runs inside
one jitted device program per block (kernels/device_stages.decode_block_core),
the device mirror of the reference's per-block Decomp() chain
(jampack.cpp:47-58).  The CRC is verified host-side after the fetch, like
the reference verifies after its chain (jampack.cpp:56-57).
"""

from functools import partial

import numpy as np

from ..format import checksum as _checksum
from ..format.constants import ANS_CHUNK_SIZE
from ..stages.ans import lane_rlen, read_chunk_header, read_lane_table


def _pow2(x: int, lo: int = 8) -> int:
    n = lo
    while n < x:
        n <<= 1
    return n


def block_meta(payload: bytes, lanes: int):
    """Parse every chunk header + lane table out of a block payload.

    Returns dict of unpadded numpy arrays: starts/rlens per chain (for
    lanes >= 2, chunk c owns chain rows [c*lanes, (c+1)*lanes)), per-chunk
    olen/rlen, and the (C, 256) rank frequency tables.
    """
    view = memoryview(payload)
    pos = 0
    starts, rlens = [], []
    olens, crlens, ftabs = [], [], []
    while pos < len(view):
        freqs, olen, clen, rlen, pos = read_chunk_header(view, pos)
        if lanes >= 2:
            lane_clens, p = read_lane_table(view, pos, rlen, lanes)
            if sum(lane_clens) != clen - (p - pos):
                raise ValueError("corrupt lane table")
            starts.extend(np.cumsum([p] + lane_clens[:-1]).tolist())
            rlens.extend(lane_rlen(rlen, lanes, l) for l in range(lanes))
        else:
            starts.append(pos)
            rlens.append(rlen)
        olens.append(olen)
        crlens.append(rlen)
        ftabs.append(freqs)
        pos += clen
    return {
        "starts": np.asarray(starts, np.int32),
        "rlens": np.asarray(rlens, np.int32),
        "chunk_olens": np.asarray(olens, np.int32),
        "chunk_rlens": np.asarray(crlens, np.int32),
        "freqs": np.asarray(ftabs, np.int32).reshape(len(olens), 256),
    }


def plan_shapes(metas, payload_lens, blocksize: int, lanes: int):
    """Common static capacities for a batch of blocks (pow2-bucketed so jit
    variants stay bounded)."""
    cmax = _pow2(max((m["chunk_olens"].size for m in metas), default=1), 1)
    lmax = cmax * max(lanes, 1)
    rmax = _pow2(max((int(m["rlens"].max()) if m["rlens"].size else 1)
                     for m in metas), 16)
    ocap = _pow2(max((int(m["chunk_olens"].max()) if m["chunk_olens"].size
                      else 1) for m in metas), 16)
    ocap = min(ocap, _pow2(ANS_CHUNK_SIZE))
    pcap = _pow2(max(payload_lens), 64)
    # the stage-buffer capacity sizes EVERY out_cap-shaped stage op (sorts,
    # scans, scatters), so a pow2 bucket wastes up to 2x wall; quantize to
    # 1 MB granularity instead (pow2 below 1 MB) — compile variants stay
    # bounded by distinct block sizes, which archives keep constant
    need = int(blocksize * 1.05) + 1024
    mb = 1 << 20
    out_cap = _pow2(need) if need < mb else ((need + mb - 1) // mb) * mb
    max_tokens = max(out_cap // 256, 4096)
    return dict(cmax=cmax, lmax=lmax, rmax=rmax, ocap=ocap, pcap=pcap,
                out_cap=out_cap, max_tokens=max_tokens)


def pack_meta(meta, payload: bytes, shapes):
    """Pad one block's metadata + payload to the batch's static shapes."""
    cmax, lmax, rmax, ocap = (shapes["cmax"], shapes["lmax"],
                              shapes["rmax"], shapes["ocap"])
    pay = np.zeros(shapes["pcap"], np.uint8)
    pay[: len(payload)] = np.frombuffer(payload, np.uint8)
    starts = np.zeros(lmax, np.int32)
    rlens = np.full(lmax, -1, np.int32)
    k = meta["starts"].size
    starts[:k] = meta["starts"]
    rlens[:k] = meta["rlens"]
    if np.any(meta["rlens"] > rmax):
        raise ValueError("chain length exceeds plan")
    olens = np.zeros(cmax, np.int32)
    crlens = np.zeros(cmax, np.int32)
    freqs = np.zeros((cmax, 256), np.int32)
    c = meta["chunk_olens"].size
    olens[:c] = meta["chunk_olens"]
    crlens[:c] = meta["chunk_rlens"]
    freqs[:c] = meta["freqs"]
    return pay, starts, rlens, olens, crlens, freqs


_JIT_CACHE = {}
_PAD_CACHE = {}


def _pay_to_device(payload: bytes, pcap: int):
    """H2D the payload at 64 KB granularity and zero-pad to the plan's
    pow2 pcap ON DEVICE: host-side padding would ship up to pcap -
    len(payload) zero bytes over the host link for nothing.  The pad
    program is trivial and cached per (bucket, pcap)."""
    import jax
    import jax.numpy as jnp

    gran = 64 << 10
    blen = min(-(-len(payload) // gran) * gran, pcap)
    buf = np.zeros(blen, np.uint8)
    buf[: len(payload)] = np.frombuffer(payload, np.uint8)
    if blen == pcap:
        return jnp.asarray(buf)
    key = (blen, pcap)
    fn = _PAD_CACHE.get(key)
    if fn is None:
        fn = jax.jit(lambda p: jnp.pad(p, (0, pcap - p.shape[0])))
        _PAD_CACHE[key] = fn
    return fn(jnp.asarray(buf))


def _jitted_core(lanes, units, rmax, ocap, out_cap, max_tokens,
                 lpx_spans=4):
    import jax

    key = (lanes, units, rmax, ocap, out_cap, max_tokens, lpx_spans)
    fn = _JIT_CACHE.get(key)
    if fn is None:
        from ..kernels.device_stages import decode_block_core

        fn = jax.jit(partial(
            decode_block_core, lanes=lanes, units=units, rmax=rmax,
            ocap=ocap, out_cap=out_cap, max_tokens=max_tokens,
            lpx_spans=lpx_spans))
        _JIT_CACHE[key] = fn
    return fn


def _host_fallback(rec) -> bytes:
    """Host decode of one framed-block record (header, payload) — used for
    valid streams whose Lpx span split exceeds the device kernel's static
    lane layout."""
    from .engines import NativeEngine
    from .pipeline import decompress_block

    header, payload = rec
    return decompress_block(payload, header.crc, NativeEngine(),
                            header.blocksize, header.units, header.lanes,
                            header.lpx_spans).tobytes()


def _jitted_batch_core(lanes, units, rmax, ocap, out_cap, max_tokens,
                       lpx_spans, batch):
    import jax

    key = ("B", batch, lanes, units, rmax, ocap, out_cap, max_tokens,
           lpx_spans)
    fn = _JIT_CACHE.get(key)
    if fn is None:
        from ..kernels.device_stages import decode_block_core

        core = partial(
            decode_block_core, lanes=lanes, units=units, rmax=rmax,
            ocap=ocap, out_cap=out_cap, max_tokens=max_tokens,
            lpx_spans=lpx_spans)

        # lax.scan over the block axis, NOT vmap: scan keeps every
        # per-block sort/loop temp 1-D (a vmapped chain lays them out
        # (B, n)) and amortizes host dispatch across the batch.
        def fn(pay, starts, rlens, olens, crlens, freqs):
            return jax.lax.scan(
                lambda c, x: (c, core(*x)), None,
                (pay, starts, rlens, olens, crlens, freqs))[1]

        fn = jax.jit(fn)
        _JIT_CACHE[key] = fn
    return fn


def decode_blocks_device(payloads, crcs, blocksize: int, units: int = 120,
                         lanes: int = 0, lpx_spans=4, _idx_map=None,
                         routes=None):
    """Decode B framed blocks in batched device programs on one device
    (the single-device mirror of the reference's multi-block OpenMP loop,
    jampack.cpp:286-328): the latency-bound stages (rank MTF lockstep,
    rANS step, anchored chase) run all B blocks' lanes together, so their
    per-step cost amortizes across the batch.  units/lanes must be shared;
    lpx_spans may be an int or a per-block sequence — -Sa auto-gated
    archives mix spans=0 and spans=S blocks by design, and each span-word
    group runs as its own batched program (the span count is a static jit
    arg), so mixed archives stay on device.  Returns decoded arrays in
    block order; routes (optional collections.Counter) receives one count
    per block, "device" or "host:lpx_layout"."""
    spans_list = ([int(lpx_spans)] * len(payloads)
                  if np.isscalar(lpx_spans) else [int(s) for s in lpx_spans])
    if len(spans_list) != len(payloads):
        raise ValueError("lpx_spans sequence length != block count")
    if len(set(spans_list)) > 1:
        by_spans = {}
        for i, s in enumerate(spans_list):
            by_spans.setdefault(s, []).append(i)
        results = [None] * len(payloads)
        for s, idxs in sorted(by_spans.items()):
            got = decode_blocks_device(
                [payloads[i] for i in idxs], [crcs[i] for i in idxs],
                blocksize, units, lanes, s,
                _idx_map=[(_idx_map or list(range(len(payloads))))[i]
                          for i in idxs], routes=routes)
            for i, g in zip(idxs, got):
                results[i] = g
        return results
    lpx_spans = spans_list[0]
    idx_map = _idx_map or list(range(len(payloads)))
    import jax

    import jax.numpy as jnp

    metas = [block_meta(p, lanes) for p in payloads]
    shapes = plan_shapes(metas, [len(p) for p in payloads], blocksize, lanes)
    packed = [pack_meta(m, p, shapes) for m, p in zip(metas, payloads)]
    stacked = [np.stack(cols) for cols in zip(*packed)]
    # ship the payload stack at 64 KB granularity, pad to pcap on device
    # (same economics as _pay_to_device, B-fold)
    gran = 64 << 10
    pcap = shapes["pcap"]
    blen = min(-(-max(len(p) for p in payloads) // gran) * gran, pcap)
    paybuf = np.zeros((len(payloads), blen), np.uint8)
    for i, p in enumerate(payloads):
        paybuf[i, : len(p)] = np.frombuffer(p, np.uint8)
    if blen == pcap:
        pay_dev = jnp.asarray(paybuf)
    else:
        import jax

        key = ("B", len(payloads), blen, pcap)
        pad = _PAD_CACHE.get(key)
        if pad is None:
            pad = jax.jit(
                lambda p: jnp.pad(p, ((0, 0), (0, pcap - p.shape[1]))))
            _PAD_CACHE[key] = pad
        pay_dev = pad(jnp.asarray(paybuf))
    fn = _jitted_batch_core(lanes, units, shapes["rmax"], shapes["ocap"],
                            shapes["out_cap"], shapes["max_tokens"],
                            lpx_spans, len(payloads))
    outs, ns, oks, sups = fn(pay_dev, *stacked[1:])
    # one status fetch for the whole batch (each scalar pull is its own
    # device-to-host round trip)
    import jax

    status = np.asarray(jax.device_get(jnp.stack(
        [ns.astype(jnp.int32), oks.astype(jnp.int32),
         sups.astype(jnp.int32)], axis=1)))
    results = []
    for i, (payload, crc) in enumerate(zip(payloads, crcs)):
        if not bool(status[i, 2]):
            from .engines import NativeEngine
            from .pipeline import decompress_block

            results.append(decompress_block(payload, crc, NativeEngine(),
                                            blocksize, units, lanes,
                                            lpx_spans))
            if routes is not None:
                routes["host:lpx_layout"] += 1
            continue
        if routes is not None:
            routes["device"] += 1
        if not bool(status[i, 1]):
            raise ValueError(
                f"device decode failed (corrupt block {idx_map[i]})")
        data = np.asarray(jax.device_get(outs[i, : int(status[i, 0])]))
        if _checksum.integrity_check(data) != (crc & 0xFFFFFFFF):
            raise ValueError(f"detected corrupt block {idx_map[i]}")
        results.append(data)
    return results


def decode_block_device(payload: bytes, crc: int, blocksize: int,
                        units: int = 120, lanes: int = 0,
                        lpx_spans: int = 4, routes=None) -> np.ndarray:
    """Decode one framed block's payload entirely on device; CRC-checks the
    fetched result.  The single-device counterpart of the sharded
    multi-device step (runtime/sharding.py).  routes: an optional
    collections.Counter that receives "device" or "host:lpx_layout"."""
    import jax
    import jax.numpy as jnp

    meta = block_meta(payload, lanes)
    shapes = plan_shapes([meta], [len(payload)], blocksize, lanes)
    packed = pack_meta(meta, payload, shapes)
    fn = _jitted_core(lanes, units, shapes["rmax"], shapes["ocap"],
                      shapes["out_cap"], shapes["max_tokens"], lpx_spans)
    out, n, ok, lpx_sup = fn(_pay_to_device(payload, shapes["pcap"]),
                             *packed[1:])
    # ONE status fetch instead of three: every scalar bool()/int() is its
    # own device-to-host round trip
    n_, ok_, lpx_sup = (int(x) for x in np.asarray(jax.device_get(
        jnp.stack([jnp.int32(n), ok.astype(jnp.int32),
                   lpx_sup.astype(jnp.int32)]))))
    if not bool(lpx_sup):
        # valid stream whose Lpx span split exceeds the kernel's static
        # lane layout (n % spans > n // spans, only when the Lpx stage is
        # shorter than spans^2): decode host-side, bit-identically
        from .engines import NativeEngine
        from .pipeline import decompress_block

        if routes is not None:
            routes["host:lpx_layout"] += 1
        return decompress_block(payload, crc, NativeEngine(), blocksize,
                                units, lanes, lpx_spans)
    if routes is not None:
        routes["device"] += 1
    if not bool(ok_):
        raise ValueError("device decode failed (corrupt stream)")
    # slice to the real length ON DEVICE: out is out_cap-padded (~12%
    # over an 8 MB block)
    data = np.asarray(jax.device_get(out[:n_]))
    if _checksum.integrity_check(data) != (crc & 0xFFFFFFFF):
        raise ValueError("detected corrupt block")
    return data
