"""Per-stage wall profile of the fused device decode (device_stages.py).

Builds the bench JT3 stream (8 MB text-like, 8 KB chunks x 16 lanes,
960 anchors, 4096 Lpx spans), then times each stage of
decode_block_core separately in its own jit, same shapes as the fused
kernel.  Each timing ends in block_until_ready.

Usage: python tools/fused_profile.py [mb]
"""

import sys
import time
from functools import partial

import numpy as np

sys.path.insert(0, ".")


def textlike(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    alpha = np.frombuffer(b" etaoinshrdlucmfwypvbgkqjxz.,\n", dtype=np.uint8)
    return alpha[(x >> 16) % 30]


def sync(x):
    import jax

    return jax.block_until_ready(x)


def main():
    import jax
    import jax.numpy as jnp

    from jampack_jax.runtime.engines import NativeEngine
    from jampack_jax.runtime.pipeline import Options, compress_block
    from jampack_jax.runtime.device_decode import (
        block_meta, pack_meta, plan_shapes)
    from jampack_jax.kernels import device_stages as ds
    from jampack_jax.kernels.rans_wide import decode_lanes_wide

    mb = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    n = (mb << 20) - ((mb << 20) % 120)
    data = textlike(n)
    # stream parameters: default to bench.py's PROD_* (round-5 frontier
    # pick) so this profiles the production path; env overrides for
    # experiments (JAMPACK_PROFILE_CHUNK in KB / _LANES / _SPANS)
    import os as _os

    import bench as _bench

    chunk = int(_os.environ.get("JAMPACK_PROFILE_CHUNK",
                                _bench.PROD_CHUNK >> 10)) << 10
    lanes = int(_os.environ.get("JAMPACK_PROFILE_LANES",
                                _bench.PROD_LANES))
    units = _bench.PROD_UNITS
    spans = int(_os.environ.get("JAMPACK_PROFILE_SPANS",
                                _bench.PROD_SPANS))
    print(f"stream: chunk={chunk >> 10}K lanes={lanes} units={units} "
          f"spans={spans}")
    opt = Options(blocksize=n, filters=0, match_finder=0,
                  rans_lanes=lanes, ans_chunk=chunk, anchor_units=units,
                  lpx_spans=spans)
    t0 = time.time()
    crc, payload = compress_block(data, opt, NativeEngine())
    print(f"encode: {time.time()-t0:.2f}s payload={len(payload)}")

    meta = block_meta(payload, lanes)
    shapes = plan_shapes([meta], [len(payload)], n, lanes)
    print("shapes:", shapes)
    pay, starts, rlens, olens, crlens, freqs = (
        jax.device_put(a) for a in pack_meta(meta, payload, shapes))
    rmax, ocap, out_cap, mtok = (shapes["rmax"], shapes["ocap"],
                                 shapes["out_cap"], shapes["max_tokens"])
    CMAX = shapes["cmax"]

    def timeit(name, fn, *args):
        r = fn(*args)
        tree = jax.tree_util.tree_leaves(r)
        sync(tree[0])
        best = float("inf")
        for _ in range(2):
            t0 = time.time()
            r = fn(*args)
            for leaf in jax.tree_util.tree_leaves(r):
                sync(leaf)
            best = min(best, time.time() - t0)
        print(f"{name:28s} {best*1e3:9.1f} ms")
        return r

    # 1. wide rANS, emitting directly in per-chunk undealt layout — time
    # BOTH the XLA lockstep kernel and the Pallas kernel (the fused
    # chain's route on a GPU, kernels/rans_pallas.py)
    f1 = jax.jit(partial(decode_lanes_wide, max_rlen=rmax, groups=CMAX))
    chunk_syms, eok = timeit("rans_wide+undeal (xla)", f1, pay, starts,
                             rlens)
    try:
        from jampack_jax.kernels.rans_pallas import decode_lanes_wide_pallas
        fp = partial(decode_lanes_wide_pallas, max_rlen=rmax, groups=CMAX)
        ps, pok = timeit("rans_wide+undeal (pallas)", fp, pay, starts,
                         rlens)
        if bool(np.array_equal(np.asarray(ps), np.asarray(chunk_syms))):
            chunk_syms, eok = ps, pok
        else:
            print("  WARNING: pallas/xla mismatch — keeping xla output")
    except Exception as e:
        print(f"  pallas kernel unavailable: {e}")

    # 3. rle0
    f3 = jax.jit(jax.vmap(lambda s, rl, ol: ds.rle0_decode_core(s, rl, ol, ocap)))
    ranks, rle_ok = timeit("rle0", f3, chunk_syms, crlens, olens)

    # 4. rank decode
    f4 = jax.jit(partial(ds.rank_decode_core, out_cap=ocap))
    chunk_bytes, rank_ok = timeit("rank_decode", f4, ranks, freqs, olens)

    # 5. concat (aligned reshape fast path, matching decode_block_core)
    @jax.jit
    def concat(chunk_bytes, olens):
        base = jnp.cumsum(olens) - olens
        total = jnp.sum(olens)
        jj = jnp.arange(ocap, dtype=jnp.int32)[None, :]
        aligned = jnp.all(
            (base == jnp.arange(CMAX, dtype=jnp.int32) * ocap)
            | (olens <= 0))

        def concat_reshape(cb):
            return cb.reshape(-1)[:out_cap]

        def concat_scatter(cb):
            flat_pos = jnp.where(jj < olens[:, None], base[:, None] + jj,
                                 out_cap)
            return jnp.zeros(out_cap + 1, jnp.uint8).at[
                flat_pos.reshape(-1)].set(cb.reshape(-1),
                                          mode="drop")[:out_cap]

        if CMAX * ocap >= out_cap:
            stage = jax.lax.cond(aligned, concat_reshape, concat_scatter,
                                 chunk_bytes)
        else:
            stage = concat_scatter(chunk_bytes)
        return stage, total

    stage, total = timeit("concat", concat, chunk_bytes, olens)

    # 6. ibwt
    f6 = jax.jit(partial(ds.ibwt_dyn_core, units=units, out_cap=out_cap))
    stage, nn, ib_ok = timeit("ibwt", f6, stage, total)

    # 7. lz (mode)
    f7 = jax.jit(partial(ds.lz_decode_dyn_core, max_tokens=mtok,
                         out_cap=out_cap))
    stage, nn, lz_ok = timeit("lz_mode", f7, stage, nn)

    # 8. lpx
    f8 = jax.jit(partial(ds.lpx_dyn_core, out_cap=out_cap, decode=True,
                         spans=spans))
    stage, lpx_sup = timeit("lpx", f8, stage, nn)
    assert bool(np.asarray(lpx_sup))

    # 9. filters
    f9 = jax.jit(partial(ds.filters_decode_dyn_core, out_cap=out_cap))
    stage, nn, f_ok = timeit("filters", f9, stage, nn)

    # 10. lz dedupe
    out, nn, lz0_ok = timeit("lz_dedupe", f7, stage, nn)

    got = np.asarray(out)[: int(nn)]
    print("bit-exact:", np.array_equal(got, data),
          "oks:", [bool(np.all(np.asarray(x))) for x in
                   (eok[rlens >= 0], rle_ok[olens > 0], rank_ok, ib_ok,
                    lz_ok, f_ok, lz0_ok)])

    # ---- the FUSED chain itself: device compute of
    # decode_block_core in one jit (no D2H in the timing), to expose any
    # gap between the fused wall and the stage sum
    print("fused jit will route rANS via:",
          "pallas" if jax.default_backend() == "gpu" else "xla")
    ffull = jax.jit(partial(
        ds.decode_block_core, lanes=lanes, units=units, rmax=rmax,
        ocap=ocap, out_cap=out_cap, max_tokens=mtok, lpx_spans=spans))
    fout, fn_, fok, fsup = timeit("FUSED decode_block_core", ffull, pay,
                                  starts, rlens, olens, crlens, freqs)
    fgot = np.asarray(fout)[: int(fn_)]
    print("fused bit-exact:", np.array_equal(fgot, data),
          "ok:", bool(np.asarray(fok)), "sup:", bool(np.asarray(fsup)))

    # ---- the WRAPPER (what bench.py times): includes host meta parse,
    # H2D of the packed payload, D2H of the sliced output, CRC
    from jampack_jax.runtime.device_decode import decode_block_device
    back = decode_block_device(payload, crc, n, units, lanes, spans)
    assert np.array_equal(back, data)
    best = float("inf")
    for _ in range(3):
        t0 = time.time()
        decode_block_device(payload, crc, n, units, lanes, spans)
        best = min(best, time.time() - t0)
    print(f"{'decode_block_device e2e':28s} {best*1e3:9.1f} ms "
          f"({n/1e9/best:.5f} GB/s)")


if __name__ == "__main__":
    main()
