"""Per-stage wall profile of the fused device encode (encode_stages.py).

Times each stage of encode_block_core separately in its own jit at the
bench JT3 configuration (8 MB text-like, store/filters-off, 8 KB chunks x
16 lanes, 960 anchors, 4096 Lpx spans), then the whole fused call.  Each
timing is the best of a few trials ending in block_until_ready.

Usage: python tools/encode_profile.py [mb]
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
    import os

    import jax

    import jax.numpy as jnp

    from jampack_jax.format.constants import FILTER_BLOCK_SIZE, LZ_MIN_MATCH
    from jampack_jax.kernels import encode_stages as es
    from jampack_jax.kernels.lpx_device import _code_span
    from jampack_jax.kernels.rans_wide import model_pairs_wide
    from jampack_jax.kernels.sa import bwt_from_prev_sorted, sa_doubling_core
    from jampack_jax.stages.lz77 import write_token

    mb = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    n = (mb << 20) - ((mb << 20) % 120)
    data = textlike(n)
    lanes, units, spans, chunk = 16, 960, 4096, 8 << 10

    def timeit(name, fn, *args):
        r = fn(*args)
        for leaf in jax.tree_util.tree_leaves(r):
            sync(leaf)
        best = float("inf")
        for _ in range(2):
            t0 = time.time()
            r = fn(*args)
            for leaf in jax.tree_util.tree_leaves(r):
                sync(leaf)
            best = min(best, time.time() - t0)
        print(f"{name:28s} {best*1e3:9.1f} ms", flush=True)
        return r

    tok = np.frombuffer(write_token(LZ_MIN_MATCH, LZ_MIN_MATCH, 0), np.uint8)
    T = tok.size
    FBS = FILTER_BLOCK_SIZE
    n1 = n + T
    nf = -(-n1 // FBS)
    n2 = n1 + 2 * nf
    n3 = n2 + T
    nlen = n3 - n3 % units
    td = jax.device_put(jnp.asarray(data))

    @jax.jit
    def store_filters(d):
        s1 = jnp.concatenate([jnp.asarray(tok), d])
        i1 = jnp.arange(n1, dtype=jnp.int32)
        dst = (i1 // FBS) * (FBS + 2) + 2 + (i1 % FBS)
        return jnp.zeros(n2, jnp.uint8).at[dst].set(s1)

    s2 = timeit("lz_store+filters0", store_filters, td)

    from jampack_jax.stages.lpx import _split_spans

    sp = _split_spans(n2, spans)
    bspan = sp[0][1]
    lens = jnp.asarray(np.asarray([ln for _, ln in sp], np.int32))

    @jax.jit
    def f_lpx(s2):
        rows = jnp.zeros(len(sp) * bspan, jnp.uint8).at[: n2].set(
            s2).reshape(len(sp), bspan)
        coded = jax.vmap(
            lambda s, ln: _code_span(s, ln, bspan, False))(rows, lens)
        return coded.reshape(-1)[:n2]

    s2 = timeit("lpx_encode", f_lpx, s2)

    @jax.jit
    def bwt(s2):
        s3 = jnp.concatenate([jnp.asarray(tok), s2])
        _, isa, prev_sorted = sa_doubling_core(s3[:nlen], nlen)
        b = bwt_from_prev_sorted(prev_sorted, isa[0], nlen)
        step = nlen // units
        anchors = isa[: units * step : step] + 1
        ab = ((anchors[:, None] >> jnp.asarray([0, 8, 16, 24])[None, :])
              & 0xFF).astype(jnp.uint8).reshape(-1)
        return jnp.concatenate([b, s3[nlen:], ab])

    s4 = timeit("forward_bwt+anchors", bwt, s2)
    n4 = n3 + 4 * units
    C = -(-n4 // chunk)
    olens = np.minimum(chunk, n4 - chunk * np.arange(C)).astype(np.int32)
    olens_j = jax.device_put(jnp.asarray(olens))

    @jax.jit
    def chunkify(s4):
        return jnp.zeros(C * chunk, jnp.uint8).at[: n4].set(
            s4).reshape(C, chunk)

    rows = timeit("chunkify", chunkify, s4)
    ranks, freqs = timeit("rank_encode", jax.jit(es.rank_encode_core),
                          rows, olens_j)
    f_rle = jax.jit(jax.vmap(lambda r, ol: es.rle0_encode_core(r, ol, chunk)))
    syms, rlens = timeit("rle0_encode", f_rle, ranks, olens_j)

    eff = max(lanes, 1)
    rcap = -(-chunk // eff) * eff
    max_rlen = rcap // eff

    @jax.jit
    def deal(syms, rlens):
        syms_p = jnp.pad(syms, ((0, 0), (0, rcap - chunk)))
        chains = syms_p.reshape(C, max_rlen, eff).transpose(0, 2, 1).reshape(
            C * eff, max_rlen)
        lane_ids = jnp.arange(eff, dtype=jnp.int32)[None, :]
        crlens = ((rlens[:, None] - lane_ids + eff - 1) // eff).reshape(-1)
        return chains, crlens

    chains, crlens = timeit("lane_deal", deal, syms, rlens)
    f_model = jax.jit(partial(model_pairs_wide, max_rlen=max_rlen))
    lows, fqs, oks = timeit("model_pairs_wide (xla)", f_model, chains,
                            crlens)
    try:
        from jampack_jax.kernels.rans_pallas import model_pairs_wide_pallas

        f_mp = jax.jit(partial(model_pairs_wide_pallas, max_rlen=max_rlen))
        plo, pfq, pok = timeit("model_pairs_wide (pallas)", f_mp, chains,
                               crlens)
        live = np.asarray(crlens)
        alo, afq = np.asarray(lows), np.asarray(fqs)
        blo, bfq = np.asarray(plo), np.asarray(pfq)
        mismatch = any(
            not (np.array_equal(alo[l, :2 * k], blo[l, :2 * k])
                 and np.array_equal(afq[l, :2 * k], bfq[l, :2 * k]))
            for l, k in enumerate(live))
        if mismatch:
            print("  WARNING: pallas/xla pairs mismatch — keeping xla")
        else:
            lows, fqs = plo, pfq
    except Exception as e:  # noqa: BLE001
        print(f"  pallas pairs unavailable: {e}")
    from jampack_jax.kernels.rans_encode import rans_reverse_encode_wide

    f_rev = jax.jit(partial(rans_reverse_encode_wide, max_rlen=max_rlen))
    bufs, ptrs = timeit("rans_reverse_wide", f_rev, lows, fqs, crlens)

    # whole fused call for the end-to-end number
    f_all = partial(es.encode_block_core, n=n, units=units, chunk=chunk,
                    lanes=lanes, lpx_spans=spans)
    out = timeit("FUSED encode_block_core", f_all, td)
    print(f"total vs sum-of-stages; {n/1e6:.1f} MB block", flush=True)


if __name__ == "__main__":
    main()
