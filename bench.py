"""Benchmark: BWT encode+decode GB/s per device on an NVIDIA GPU.

Runs the device BWT codec cycle on one default-size block (8 MB,
format.hpp:20) of synthetic text-like data:

  forward = prefix-doubling suffix sort + BWT emission + anchor planting
  inverse = LF map build + 120-unit anchored chase (reference-compatible)

steady-state timed after a compile warmup (each timed call ends in
block_until_ready), plus the end-to-end fused encode/decode numbers in
"extra".  Prints the device and the card's power limit on stderr first,
then ONE JSON line on stdout:

    {"metric": ..., "value": N, "unit": "GB/s/chip", "vs_baseline": N}

Exits non-zero without a result when JAX finds no GPU.

vs_baseline compares against the reference implementation's BWT stage
(divsufsort forward + 120-unit anchored inverse), measured once with
tools/ref_bwt_bench.cpp on one core of an x86 host on the same synthetic
text at the same block size: 8 MB -> fwd 10.0 MB/s, inv 37.5 MB/s,
combined 0.0158 GB/s.
"""

import json
import sys
import time

import numpy as np

# Reference combined BWT encode+decode GB/s at 8 MB (tools/ref_bwt_bench.cpp,
# one x86 core).
REF_BWT_COMBINED_GBPS = 0.0158

# JAM-default archive bytes on THIS bench corpus (8 MB textlike, m0/f1,
# 1 MB chunks, 4-state rANS — the reference's stream), from
# tools/ratio_frontier.py --sizes.  Every JT3 config's ratio cost below is
# disclosed against this number.
JAM_TEXT_BYTES = 5_212_192

# The production JT3 native-stream parameters priced by the fused e2e
# keys, picked on the ratio side of the frontier (ARCHITECTURE.md): the
# stream's body cost is ~45 B of model-warmup loss PER lockstep chain
# (chunks x lanes) + ~292 B of header per chunk, and 16K x 4 costs +5.1%
# vs the JAM stream on this corpus.
PROD_CHUNK = 16 << 10
PROD_LANES = 4
PROD_UNITS = 960
PROD_SPANS = 4096  # with lpx_auto the gate frames 0 on this corpus


def textlike(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    alpha = np.frombuffer(b" etaoinshrdlucmfwypvbgkqjxz.,\n", dtype=np.uint8)
    return alpha[(x >> 16) % 30]


def main():
    import subprocess

    import jax
    import jax.numpy as jnp

    if jax.default_backend() != "gpu":
        print(f"bench: needs a GPU; JAX's backend is {jax.default_backend()}",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(f"device: {jax.devices()[0].device_kind} x{len(jax.devices())}; "
          f"{smi.stdout.strip()}", file=sys.stderr, flush=True)

    from jampack_jax.kernels.ibwt import chase_combined_core, combined_map_core
    from jampack_jax.kernels.sa import bwt_from_prev_sorted, sa_doubling_core

    mb = 8
    n = (mb << 20) - ((mb << 20) % (120 * 16))
    data = textlike(n)
    td = jax.device_put(jnp.asarray(data))

    def make_fns(units):
        step = n // units

        # both directions fuse: emission is gather-free
        @jax.jit
        def forward(t):
            sa, isa, prev_sorted = sa_doubling_core(t, n)
            bwt = bwt_from_prev_sorted(prev_sorted, isa[0], n)
            return bwt, isa[: units * step : step] + 1

        @jax.jit
        def inverse(bwt, anchors):
            cmap = combined_map_core(bwt, anchors[0], n)
            return chase_combined_core(cmap, anchors, n, units)

        return forward, inverse

    def run(units, reps=3, trials=3):
        """Best-of-trials wall per direction, each call synced with
        block_until_ready."""
        forward, inverse = make_fns(units)
        bwt, anchors = forward(td)  # warmup compiles
        out = jax.block_until_ready(inverse(bwt, anchors))
        t_fwd = t_inv = float("inf")
        for _ in range(trials):
            t0 = time.perf_counter()
            for _ in range(reps):
                bwt, anchors = jax.block_until_ready(forward(td))
            t_fwd = min(t_fwd, (time.perf_counter() - t0) / reps)
            t0 = time.perf_counter()
            for _ in range(reps):
                out = jax.block_until_ready(inverse(bwt, anchors))
            t_inv = min(t_inv, (time.perf_counter() - t0) / reps)
        exact = np.array_equal(np.asarray(jax.device_get(out)), data)
        return t_fwd, t_inv, exact

    # metric of record: reference-compatible stream (120 anchor units,
    # jampack.cpp's fixed count); native JT3 streams raise the anchor count
    # (-u#) to cut the serial chase depth — report that too
    t_fwd, t_inv, exact = run(120)
    t_fwd_n, t_inv_n, exact_n = run(1920)
    native_gbps = 2 * n / 1e9 / (t_fwd_n + t_inv_n)
    value = 2 * n / 1e9 / (t_fwd + t_inv)
    extra = _e2e_metrics(data)
    extra["bwt_codec_device_native_stream_u1920_gbps"] = (
        round(native_gbps, 5) if exact_n else "error: inverse mismatch")
    result = {
        "metric": "bwt_codec_device_combined_8mb",
        "value": round(value, 5),
        "unit": "GB/s/chip",
        "vs_baseline": round(value / REF_BWT_COMBINED_GBPS, 3),
        "extra": extra,
    }
    print(json.dumps(result))
    if not exact:
        print("WARNING: inverse mismatch", file=sys.stderr)
        sys.exit(1)


def _best_of(fn, trials: int = 3) -> float:
    """Best-of-trials wall time of fn(), which returns host bytes (its own
    sync point)."""
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _e2e_metrics(data: np.ndarray) -> dict:
    """Secondary end-to-end numbers: the fully device-resident fused
    encode and decode chains on the 8 MB block, plus native encode MB/s.
    Failures degrade to error strings so the primary metric always
    prints.  Every timed entry is best-of-3 after a warmup call."""
    out = {}
    n = int(data.size)
    try:
        from jampack_jax.runtime.engines import NativeEngine
        from jampack_jax.runtime.pipeline import Options, compress_block

        ne = NativeEngine()
        opt = Options(blocksize=n, filters=0, match_finder=0)
        crc, payload = compress_block(data, opt, ne)  # warmup
        out["encode_native_8mb_mbps"] = round(
            n / 1e6 / _best_of(lambda: compress_block(data, opt, ne)), 2)
    except Exception as e:  # pragma: no cover
        out["encode_native_8mb_mbps"] = f"error: {e}"

    try:
        from jampack_jax.runtime.device_encode import encode_block_device
        from jampack_jax.runtime.pipeline import Options as _O

        # fused device ENCODE (store/filters-off JT3 config): LZ store ->
        # filters -> Lpx -> forward BWT -> rank -> RLE0 -> reverse rANS in
        # one jit on the 8 MB block
        eopt = _O(blocksize=n, match_finder=3, filters=0,
                  rans_lanes=PROD_LANES, ans_chunk=PROD_CHUNK,
                  anchor_units=PROD_UNITS, lpx_spans=PROD_SPANS)
        crc_e, pay_e = encode_block_device(data, eopt)  # warmup/compile
        from jampack_jax.runtime.engines import NativeEngine as _NE
        from jampack_jax.runtime.pipeline import compress_block as _cb
        assert (crc_e, pay_e) == _cb(data, eopt, _NE())  # byte contract
        out["encode_e2e_device_fused_8mb_mbps"] = round(
            n / 1e6 / _best_of(lambda: encode_block_device(data, eopt)), 2)

    except Exception as e:  # pragma: no cover
        out["encode_e2e_device_fused_8mb_mbps"] = f"error: {e}"

    crc_a = pay_a = aopt = None
    try:
        # production native-stream encode: the Lpx auto gate measures no
        # gain on this corpus, so the device chain runs with spans=0 (the
        # host encoder would frame the same choice — see the decode-side
        # auto metric); byte contract vs the host engine at spans=0
        from jampack_jax.runtime.device_encode import encode_block_device
        from jampack_jax.runtime.engines import NativeEngine as _NE
        from jampack_jax.runtime.pipeline import Options as _O
        from jampack_jax.runtime.pipeline import compress_block_ex as _cbx

        aopt = _O(blocksize=n, match_finder=3, filters=0,
                  rans_lanes=PROD_LANES, ans_chunk=PROD_CHUNK,
                  anchor_units=PROD_UNITS, lpx_spans=0)
        crc_a, pay_a = encode_block_device(data, aopt)  # warmup/compile
        ch, ph, su = _cbx(data, aopt, _NE())
        assert (crc_a, pay_a) == (ch, ph) and su == 0
        out["encode_e2e_device_fused_8mb_auto_mbps"] = round(
            n / 1e6 / _best_of(lambda: encode_block_device(data, aopt)), 2)
        # device-COMPUTE mirror (inputs staged, splice excluded)
        from jampack_jax.runtime.metrics import fused_encode_compute_wall

        tec = fused_encode_compute_wall(data, aopt)
        out["encode_compute_device_fused_8mb_auto_mbps"] = round(
            n / 1e6 / tec, 2)
    except Exception as e:  # pragma: no cover
        out["encode_e2e_device_fused_8mb_auto_mbps"] = f"error: {e}"

    try:
        # aggregate multi-block ENCODE on one device (jampack.cpp:193-224
        # counterpart): B=4 blocks in one batched device program
        from jampack_jax.runtime.device_encode import encode_blocks_device

        assert pay_a is not None, "auto encode unavailable"
        eblocks = [data] + [textlike(n, seed=s) for s in (1, 2, 3)]
        got = encode_blocks_device(eblocks, aopt)  # warmup + compile
        assert got[0][:2] == (crc_a, pay_a)
        out["encode_aggregate_b4_mbps"] = round(
            4 * n / 1e6 / _best_of(
                lambda: encode_blocks_device(eblocks, aopt), trials=2), 2)
    except Exception as e:  # pragma: no cover
        out["encode_aggregate_b4_mbps"] = f"error: {e}"

    try:
        from jampack_jax.runtime.device_decode import decode_block_device
        from jampack_jax.runtime.engines import NativeEngine
        from jampack_jax.runtime.pipeline import Options, compress_block

        # JT3 wide-interleave stream sized for the device chain on the
        # ratio x speed frontier (PROD_* above)
        opt = Options(blocksize=n, filters=0, match_finder=0,
                      rans_lanes=PROD_LANES, ans_chunk=PROD_CHUNK,
                      anchor_units=PROD_UNITS, lpx_spans=PROD_SPANS)
        crc, payload = compress_block(data, opt, NativeEngine())
        back = decode_block_device(payload, crc, opt.blocksize,
                                   opt.anchor_units, opt.rans_lanes,
                                   opt.lpx_spans)  # warmup
        assert np.array_equal(back, data)
        out["decode_e2e_device_fused_8mb_gbps"] = round(n / 1e9 / _best_of(
            lambda: decode_block_device(payload, crc, opt.blocksize,
                                        opt.anchor_units, opt.rans_lanes,
                                        opt.lpx_spans)), 5)
    except Exception as e:  # pragma: no cover
        out["decode_e2e_device_fused_8mb_gbps"] = f"error: {e}"

    opt = spans_used = None
    try:
        # the PRODUCTION native-stream path (round 4): the encoder's
        # per-block Lpx auto gate measures no gain on this corpus and
        # frames spans=0, so the decoder skips its dominant serial-walk
        # term — same bit-exact contract, ratio cost quantified in
        # tools/lpx_gate_calib.py
        from jampack_jax.runtime.device_decode import decode_block_device
        from jampack_jax.runtime.engines import NativeEngine
        from jampack_jax.runtime.pipeline import Options, compress_block_ex

        opt = Options(blocksize=n, filters=0, match_finder=0,
                      rans_lanes=PROD_LANES, ans_chunk=PROD_CHUNK,
                      anchor_units=PROD_UNITS, lpx_spans=PROD_SPANS,
                      lpx_auto=True)
        crc, payload, spans_used = compress_block_ex(data, opt,
                                                     NativeEngine())
        # the RATIO this stream pays vs the reference's JAM default on
        # the same corpus — the disclosure every speed key below is
        # priced with (tools/ratio_frontier.py table)
        out["ratio_vs_jam_default_pct"] = round(
            100 * (len(payload) / JAM_TEXT_BYTES - 1), 2)
        back = decode_block_device(payload, crc, opt.blocksize,
                                   opt.anchor_units, opt.rans_lanes,
                                   spans_used)  # warmup
        assert np.array_equal(back, data)
        out["decode_e2e_device_fused_8mb_auto_gbps"] = round(
            n / 1e9 / _best_of(
                lambda: decode_block_device(payload, crc, opt.blocksize,
                                            opt.anchor_units,
                                            opt.rans_lanes, spans_used)), 5)
        out["lpx_auto_spans_used"] = spans_used
        # device-COMPUTE mirror of the auto decode
        from jampack_jax.runtime.metrics import fused_decode_compute_wall

        tdc = fused_decode_compute_wall(payload, opt.blocksize,
                                        opt.anchor_units, opt.rans_lanes,
                                        spans_used)
        out["decode_compute_device_fused_8mb_auto_gbps"] = round(
            n / 1e9 / tdc, 5)
    except Exception as e:  # pragma: no cover
        out["decode_e2e_device_fused_8mb_auto_gbps"] = f"error: {e}"
        spans_used = None

    try:
        # aggregate multi-block throughput on ONE device (the counterpart of the reference's multi-block OpenMP loop,
        # jampack.cpp:286-328): B=4 blocks batched into one device
        # program; latency-bound stages amortize across the batch
        from jampack_jax.runtime.device_decode import decode_blocks_device
        from jampack_jax.runtime.engines import NativeEngine
        from jampack_jax.runtime.pipeline import compress_block_ex

        assert spans_used is not None, "auto decode unavailable"
        B = 4
        blocks = [data] + [textlike(n, seed=s) for s in (1, 2, 3)]
        crcs, payloads = [], []
        for b in blocks:
            c, p, su = compress_block_ex(b, opt, NativeEngine())
            assert su == spans_used
            crcs.append(c)
            payloads.append(p)
        outs = decode_blocks_device(payloads, crcs, opt.blocksize,
                                    opt.anchor_units, opt.rans_lanes,
                                    spans_used)  # warmup + compile
        for got, want in zip(outs, blocks):
            assert np.array_equal(got, want)
        agg = B * n / 1e9 / _best_of(
            lambda: decode_blocks_device(payloads, crcs, opt.blocksize,
                                         opt.anchor_units, opt.rans_lanes,
                                         spans_used), trials=2)
        out["decode_aggregate_b4_gbps"] = round(agg, 5)
    except Exception as e:  # pragma: no cover
        out["decode_aggregate_b4_gbps"] = f"error: {e}"
    return out


if __name__ == "__main__":
    main()
