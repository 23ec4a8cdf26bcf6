"""Multi-chip block sharding: data-parallel codec steps over a device mesh.

The format is embarrassingly parallel (each framed block is self-contained),
so the distributed design is: shard a batch of fixed-size blocks along a
`data` mesh axis with shard_map, run the full per-block transform stack
on each device, and reduce per-block metrics with psum across the mesh.  Compressed
variable-length outputs are size-prefixed into fixed budgets and gathered in
file order on the host (SURVEY.md section 5.8).

Multi-host: the same mesh spans hosts via jax.distributed.initialize();
blocks are read per-host, decoded locally, written per-host and concatenated
in index order — no cross-host data dependencies exist at all.
"""

from collections import Counter
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map as _shard_map


def shard_map(f, mesh, in_specs, out_specs):
    return _shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                      check_vma=False)


def make_mesh(n_devices=None):
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), axis_names=("data",))


def codec_block_step(block):
    """Full device transform cycle on one fixed-size block: Lpx XOR-prediction
    encode, forward BWT (suffix sort + emission + anchor planting), then
    the inverses (LF map + 120-chain chase, Lpx decode).  Returns
    (reconstruction, bwt, checksum-ish metric).  This is the flagship
    jittable compute step of the framework; it composes the same traceable
    cores the single-chip kernels jit (kernels/sa.py, ibwt.py, lpx_device.py)."""
    from ..kernels.ibwt import chase_combined_core, combined_map_core
    from ..kernels.lpx_device import _code_span
    from ..kernels.sa import bwt_from_prev_sorted, sa_doubling_core

    n = block.shape[0]
    units = 120 if n % 120 == 0 else 1
    step = n // units

    # Lpx: 4 equal spans in lockstep (lpx.cpp:150-169); require 4 | n for
    # the jittable step (the host wrappers handle ragged spans)
    def lpx(buf, decode):
        if n % 4 != 0 or n < 4:
            return buf
        spans = buf.reshape(4, n // 4)
        lens = jnp.full(4, n // 4, jnp.int32)
        out = jax.vmap(lambda s, ln: _code_span(s, ln, n // 4, decode))(
            spans, lens
        )
        return out.reshape(n)

    filtered = lpx(block, decode=False)

    sa, isa, prev_sorted = sa_doubling_core(filtered, n)
    bwt = bwt_from_prev_sorted(prev_sorted, isa[0], n)
    anchors = isa[: units * step : step] + 1  # ISA[u*step]+1, bwt.cpp:44-48

    cmap = combined_map_core(bwt, anchors[0], n)
    recon_f = chase_combined_core(cmap, anchors, n, units)
    recon = lpx(recon_f, decode=True)
    metric = jnp.sum(bwt.astype(jnp.uint32))
    return recon, bwt, metric


def sharded_codec_step(mesh: Mesh):
    """Builds the jitted data-parallel step over `mesh`: each device runs the
    full block transform on its shard; per-block metrics psum across the mesh."""

    def per_shard(local_blocks):
        recon, bwt, metric = jax.vmap(codec_block_step)(local_blocks)
        total = jax.lax.psum(jnp.sum(metric), axis_name="data")
        return recon, bwt, total

    return jax.jit(
        shard_map(
            per_shard,
            mesh,
            (P("data", None),),
            (P("data", None), P("data", None), P()),
        )
    )


def sharded_full_decode_step(mesh: Mesh, lanes: int, units: int, shapes,
                             lpx_spans: int = 4):
    """The real multi-chip decode: each device runs the ENTIRE per-block
    decode chain (wide rANS -> RLE0 -> rank -> inverse BWT -> LZ -> Lpx ->
    filters -> LZ) on its own framed block — the device mirror of the
    reference's parallel block loop (jampack.cpp:313-317 running
    jampack.cpp:47-58 per instance).  One block per device per call so the
    block-level lax.cond fast paths (LPC, inline filters) stay real
    branches rather than vmap-selects."""
    from functools import partial as _partial

    from ..kernels.device_stages import decode_block_core

    core = _partial(
        decode_block_core, lanes=lanes, units=units, rmax=shapes["rmax"],
        ocap=shapes["ocap"], out_cap=shapes["out_cap"],
        max_tokens=shapes["max_tokens"], lpx_spans=lpx_spans)

    def per_shard(pay, starts, rlens, olens, crlens, freqs):
        out, n, ok, sup = core(pay[0], starts[0], rlens[0], olens[0],
                               crlens[0], freqs[0])
        done = jax.lax.psum((n > 0).astype(jnp.int32), axis_name="data")
        return out[None], n[None], ok[None], sup[None], done

    return jax.jit(
        shard_map(
            per_shard,
            mesh,
            (P("data", None), P("data", None), P("data", None),
             P("data", None), P("data", None), P("data", None, None)),
            (P("data", None), P("data"), P("data"), P("data"), P()),
        )
    )


def sharded_full_encode_step(mesh: Mesh, n: int, units: int, chunk: int,
                             lanes: int, lpx_spans: int,
                             with_filters: bool = False,
                             lpx_auto: bool = False):
    """The multi-chip ENCODE mirror of sharded_full_decode_step: each
    device runs the entire per-block encode chain (LZ store framing ->
    filters -> Lpx -> forward BWT -> rank -> RLE0 -> reverse rANS) on its
    own raw block — the device counterpart of the reference's parallel
    compress loop (jampack.cpp:215-219 running jampack.cpp:30-42 per
    instance).  One block per device per call; n is the (static) block
    length shared by the batch.  with_filters adds the per-block (F, 2)
    filter-config operand (picks from the host-side device search).
    lpx_auto runs the per-block Lpx gate on every device (the kept flag
    comes back per block; frame spans=0 where False)."""
    from functools import partial as _partial

    from ..kernels.encode_stages import encode_block_core

    core = _partial(encode_block_core, n=n, units=units, chunk=chunk,
                    lanes=lanes, lpx_spans=lpx_spans, lpx_auto=lpx_auto)

    if with_filters:
        def per_shard(blocks, fconfigs):
            bufs, ptrs, oks, freqs, rlens, kept = core(blocks[0],
                                                       fconfigs[0])
            done = jax.lax.psum(jnp.int32(1), axis_name="data")
            return (bufs[None], ptrs[None], oks[None], freqs[None],
                    rlens[None], kept[None], done)

        in_specs = (P("data", None), P("data", None, None))
    else:
        def per_shard(blocks):
            bufs, ptrs, oks, freqs, rlens, kept = core(blocks[0])
            done = jax.lax.psum(jnp.int32(1), axis_name="data")
            return (bufs[None], ptrs[None], oks[None], freqs[None],
                    rlens[None], kept[None], done)

        in_specs = (P("data", None),)

    return jax.jit(
        shard_map(
            per_shard,
            mesh,
            in_specs,
            (P("data", None, None), P("data", None), P("data", None),
             P("data", None, None), P("data", None), P("data"), P()),
        )
    )


def encode_archive_sharded(inp, out, opt, mesh: Mesh = None, engine=None,
                           progress=None, routes=None):
    """Compress a whole stream with one raw block per device: reads blocks
    on the host, runs the fused device encode chain across the mesh in
    batches of mesh size (equal-length blocks batch together; the ragged
    tail block takes the single-device path or, below the device
    minimum, the host engine — all paths produce byte-identical archives),
    splices format metadata around the device payloads, and writes framed
    blocks in file order.  Replicates compress_stream's feof-driven
    trailing-empty-block semantics (jampack.cpp:205-214).

    routes: an optional collections.Counter that receives one count per
    block under the path it took: "device", "host:small" (below the
    device minimum) or "host:<reason>" (a configuration the device chain
    does not cover)."""
    from ..format import checksum as _checksum
    from ..format import framing
    from ..format.constants import ANS_CHUNK_SIZE
    from .device_encode import (encode_block_device, filter_configs,
                                splice_payload, stage4_len)
    from .pipeline import Engine, LZ_MODE_STORE, compress_block_ex

    if opt.match_finder not in (0, 1, 2, LZ_MODE_STORE) \
            or opt.filters not in (0, 1, 2):
        raise NotImplementedError(
            "device encode supports match_finder 0-3 + filters 0/1/2")
    mesh = mesh or make_mesh()
    D = mesh.devices.size
    blocks = []
    pending_empty = True
    while True:
        b = inp.read(opt.blocksize)
        if len(b) == 0 and not pending_empty:
            break
        blocks.append(np.frombuffer(b, dtype=np.uint8))
        if len(b) == 0:
            break
        pending_empty = len(b) == opt.blocksize

    units = int(opt.anchor_units)
    chunk = min(max(int(opt.ans_chunk), 1), ANS_CHUNK_SIZE)
    lanes = int(opt.rans_lanes)
    dev_min = max(4 * units, 1024)
    payloads = [None] * len(blocks)
    crcs = [0] * len(blocks)
    # per-block Lpx span word (lpx_auto host paths may gate a block to 0;
    # device-encoded blocks always use the configured count)
    spans_used = [int(opt.lpx_spans)] * len(blocks)
    done = [0, 0]  # (raw, comp) bytes with a finished payload
    routes = routes if routes is not None else Counter()

    def _tick(i, route="device"):
        routes[route] += 1
        if progress is None:
            return
        done[0] += blocks[i].size
        done[1] += len(payloads[i])
        progress(done[0], done[1])

    if opt.match_finder != LZ_MODE_STORE:
        # default-pipeline modes (m0 dedupe pre-pass + configured finder):
        # host LZ around the device front/back cores, one block at a time
        # — archives byte-identical to the host engines
        from .device_encode import encode_block_device_lz

        for i, blk in enumerate(blocks):
            try:
                crcs[i], payloads[i] = encode_block_device_lz(
                    blk, opt, engine)
                route = "device"
            except NotImplementedError as e:
                crcs[i], payloads[i], spans_used[i] = compress_block_ex(
                    blk, opt, engine or Engine())
                route = "host:small" if blk.size < dev_min else f"host:{e}"
            _tick(i, route)
        by_len = {}
    else:
        # group device-eligible blocks by length (archives keep the block
        # size constant except the tail, so this is one group + maybe one
        # straggler)
        by_len = {}
        for i, blk in enumerate(blocks):
            if blk.size >= dev_min:
                by_len.setdefault(blk.size, []).append(i)
            else:  # tiny tail: host engine, byte-identical by construction
                crcs[i], payloads[i], spans_used[i] = compress_block_ex(
                    blk, opt, engine or Engine())
                _tick(i, "host:small")

    for n, idxs in by_len.items():
        if len(idxs) == 1:
            # single straggler: the per-block device path (under lpx_auto
            # the gate runs on device inside the fused jit and the span
            # choice lands in the framing word)
            from .device_encode import encode_block_device_ex

            i = idxs[0]
            crcs[i], payloads[i], spans_used[i] = \
                encode_block_device_ex(blocks[i], opt)
            _tick(i)
            continue
        step = sharded_full_encode_step(mesh, n, units, chunk, lanes,
                                        int(opt.lpx_spans),
                                        with_filters=opt.filters > 0,
                                        lpx_auto=bool(
                                            getattr(opt, "lpx_auto", False)))
        sharding1 = NamedSharding(mesh, P("data", None))
        sharding2 = NamedSharding(mesh, P("data", None, None))
        for b0 in range(0, len(idxs), D):
            batch = idxs[b0 : b0 + D]
            stack = [blocks[i] for i in batch]
            cfgs = [filter_configs(blocks[i], opt.filters) for i in batch]
            while len(stack) < D:  # pad the final batch with block 0
                stack.append(stack[0])
                cfgs.append(cfgs[0])
            args = [jax.device_put(np.stack(stack), sharding1)]
            if opt.filters > 0:
                args.append(jax.device_put(np.stack(cfgs), sharding2))
            bufs, ptrs, oks, freqs, rlens, kepts, _ = step(*args)
            bufs = np.asarray(jax.device_get(bufs))
            ptrs = np.asarray(jax.device_get(ptrs))
            oks = np.asarray(jax.device_get(oks))
            freqs = np.asarray(jax.device_get(freqs))
            rlens = np.asarray(jax.device_get(rlens))
            kepts = np.asarray(jax.device_get(kepts))
            for j, i in enumerate(batch):
                if not bool(oks[j].all()):
                    raise ValueError("model failure (CDF): chunk not "
                                     "encodable in ref-compat mode")
                crcs[i] = _checksum.integrity_check(blocks[i])
                payloads[i] = splice_payload(
                    bufs[j], ptrs[j], freqs[j], rlens[j],
                    stage4_len(n, units), chunk, lanes)
                spans_used[i] = int(opt.lpx_spans) if bool(kepts[j]) else 0
                _tick(i)

    raw = comp = 0
    for i, blk in enumerate(blocks):
        framing.write_block(out, crcs[i], payloads[i], opt.blocksize,
                            opt.anchor_units, opt.rans_lanes, spans_used[i])
        raw += blk.size
        comp += len(payloads[i]) + framing.HEADER_SIZE
    return raw, comp


def decode_archive_sharded(inp, mesh: Mesh = None, progress=None,
                           routes=None):
    """Decode a whole archive (file object) with one framed block per
    device: reads + meta-parses block headers on the host (format metadata
    only), runs the fused device decode chain across the mesh in batches of
    mesh size, CRC-checks each fetched block, and returns the plaintext
    bytes in file order.  routes: an optional collections.Counter that
    receives one count per block, "device" or "host:lpx_layout" (an Lpx
    span split the device kernel's lane layout cannot express)."""
    from ..format import framing
    from ..format import checksum as _checksum
    from .device_decode import block_meta, pack_meta, plan_shapes

    mesh = mesh or make_mesh()
    D = mesh.devices.size
    recs = []
    while True:
        rec = framing.read_block(inp)
        if rec is None:
            break
        recs.append(rec)
    if not recs:
        return b""
    units = recs[0][0].units
    lanes = recs[0][0].lanes
    blocksize = max(r[0].blocksize for r in recs)
    if any(r[0].units != units or r[0].lanes != lanes for r in recs):
        raise ValueError("mixed stream parameters in one archive")
    # lpx_spans is PER BLOCK by design: the -Sa auto gate frames spans=0
    # on blocks where the Lpx stage earns nothing and keeps the configured
    # count elsewhere, so production archives mix span words.  Group
    # blocks by span word (one jitted step per word — it's a static arg)
    # and decode each group across the mesh; output stays in file order.
    metas = []
    for i, r in enumerate(recs):
        try:
            metas.append(block_meta(r[1], lanes))
        except ValueError as e:  # attribute host-side parse failures
            raise ValueError(f"corrupt block {i}: {e}") from e
    shapes = plan_shapes(metas, [len(r[1]) for r in recs], blocksize, lanes)
    by_spans = {}
    for i, r in enumerate(recs):
        by_spans.setdefault(int(r[0].lpx_spans), []).append(i)
    sharding1 = NamedSharding(mesh, P("data", None))
    sharding2 = NamedSharding(mesh, P("data", None, None))

    out_parts = [None] * len(recs)
    done = [0, 0]  # cumulative (raw, comp) bytes across groups
    routes = routes if routes is not None else Counter()
    for lpx_spans, idxs in sorted(by_spans.items()):
        step = sharded_full_decode_step(mesh, lanes, units, shapes,
                                        lpx_spans)
        _decode_group_sharded(
            step, idxs, recs, metas, shapes, D, sharding1, sharding2,
            out_parts, progress, done, routes)
    return b"".join(out_parts)


def _decode_group_sharded(step, idxs, recs, metas, shapes, D, sharding1,
                          sharding2, out_parts, progress, done, routes):
    """Decode one span-word group of blocks across the mesh in batches of
    mesh size, writing plaintext into out_parts at the blocks' archive
    positions.  done = mutable cumulative (raw, comp) counters shared
    across groups for the progress callback; routes counts each block's
    path."""
    from ..format import checksum as _checksum
    from .device_decode import pack_meta

    def _tick(i, route="device"):
        routes[route] += 1
        if progress is None:
            return
        done[0] += len(out_parts[i])
        done[1] += recs[i][0].csize
        progress(done[0], done[1])

    for b0 in range(0, len(idxs), D):
        batch = idxs[b0 : b0 + D]
        packed = [pack_meta(metas[i], recs[i][1], shapes) for i in batch]
        while len(packed) < D:  # pad the final batch with the group head
            packed.append(packed[0])
        cols = list(zip(*packed))
        args = [
            jax.device_put(np.stack(c), sharding2 if c[0].ndim == 2
                           else sharding1)
            for c in cols
        ]
        out, ns, oks, sups, _ = step(*args)
        out = np.asarray(jax.device_get(out))
        ns = np.asarray(jax.device_get(ns))
        oks = np.asarray(jax.device_get(oks))
        sups = np.asarray(jax.device_get(sups))
        for j, i in enumerate(batch):
            if not bool(sups[j]):
                # Lpx span split beyond the kernel's static lane layout:
                # this block decodes host-side, bit-identically
                from .device_decode import _host_fallback

                out_parts[i] = _host_fallback(recs[i])
                _tick(i, "host:lpx_layout")
                continue
            if not bool(oks[j]):
                raise ValueError(
                    f"device decode failed (corrupt stream) at block {i}")
            data = out[j, : int(ns[j])]
            if _checksum.integrity_check(data) != (recs[i][0].crc & 0xFFFFFFFF):
                raise ValueError(f"detected corrupt block {i}")
            out_parts[i] = data.tobytes()
            _tick(i)


def roundtrip_blocks(blocks: np.ndarray, mesh: Mesh = None):
    """Host entry: blocks (B, L) uint8, B divisible by mesh size.  Returns
    (reconstruction, bwt, metric) gathered in block order."""
    mesh = mesh or make_mesh()
    step = sharded_codec_step(mesh)
    sharded = jax.device_put(
        jnp.asarray(blocks), NamedSharding(mesh, P("data", None))
    )
    recon, bwt, metric = step(sharded)
    return (np.asarray(recon), np.asarray(bwt), int(metric))
