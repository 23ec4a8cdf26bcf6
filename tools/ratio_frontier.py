"""Speed x ratio frontier for the native JT3 stream parameters.

The reference's entropy design point — 1 MB model-reset chunks, 4
interleaved rANS states (ans.hpp:21, ans.cpp:136-140) — is a RATIO choice;
the JT3 speed configs re-parameterize it (smaller chunks x more lanes =
more lockstep chains = faster device decode) and every chunk boundary
costs a fresh chunk header (256-entry freq table) plus per-lane state
flushes and lane-table varints.  This tool publishes both axes so the
production config is picked on the frontier, not on speed alone.

  python tools/ratio_frontier.py --sizes [--mb N]   # host-only: archive bytes
  python tools/ratio_frontier.py --speed [--mb N]   # on-chip: fused walls

--sizes encodes the 8 calibration corpora (tools/lpx_gate_calib.py) with
the native engine at every (ans_chunk x rans_lanes) grid point in the
bench's own pipeline mode (m0/f0 + -Sa auto gate, the decode-bench
stream) and prints bytes + % vs the JAM-default stream (m0/f1, 1 MB
chunks, 4-state rANS, 120 units, 4 spans — the reference's stream).

--speed times decode_block_device / encode_block_device on the bench
corpus for the leading configs (chunk/lanes pairs that hold the lockstep
width), best-of-3 after warmup, wall incl. transfers plus device-compute
(transfers outside the timed region).

Key identity: serial rANS steps per block = ans_chunk / lanes (all
chunks' lanes run in ONE lockstep program), and lockstep width =
(n / ans_chunk) * lanes.  So 64K x 128 has the SAME shape as 8K x 16
while paying 1/8 the chunk-header bytes.
"""

import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np

from tools.lpx_gate_calib import corpora, textlike  # noqa: E402

GRID_CHUNKS = [8 << 10, 64 << 10, 256 << 10, 1 << 20]
GRID_LANES = [4, 16, 64, 128, 256]


def _opt(chunk, lanes, units=960, auto=True, mb=8):
    from jampack_jax.runtime.pipeline import Options

    n = (mb << 20) - ((mb << 20) % (120 * 16))
    return Options(blocksize=n, filters=0, match_finder=0, rans_lanes=lanes,
                   ans_chunk=chunk, anchor_units=units, lpx_spans=4096,
                   lpx_auto=auto)


def sizes(mb: int):
    from jampack_jax.runtime.engines import NativeEngine
    from jampack_jax.runtime.pipeline import Options, compress_block_ex

    n = (mb << 20) - ((mb << 20) % (120 * 16))
    ne = NativeEngine()
    data = {name: d[:n] for name, d in corpora(n)}

    # the JAM-default stream (the reference's ratio design point)
    jam_opt = Options(blocksize=n, filters=1, match_finder=0, rans_lanes=0,
                      ans_chunk=1 << 20, anchor_units=120, lpx_spans=4)
    jam = {}
    for name, d in data.items():
        _, pay, _ = compress_block_ex(d, jam_opt, ne)
        jam[name] = len(pay)
    jam_total = sum(jam.values())
    print(f"JAM default (m0/f1, 1M chunks, 4-state): "
          f"total {jam_total:,} B over {len(jam)} corpora x {mb} MB")
    for name in jam:
        print(f"  {name:8s} {jam[name]:>10,}")

    # same-pipeline reference entropy point (m0/f0 -Sa at 1M chunks,
    # 4-state classic stream): isolates the STREAM-PARAMETER cost of each
    # grid point from the pipeline-mode (f1, Lpx) differences vs JAM
    base_opt = _opt(1 << 20, 0, mb=mb)
    base = {}
    for name, d in data.items():
        _, pay, _ = compress_block_ex(d, base_opt, ne)
        base[name] = len(pay)
    base_total = sum(base.values())
    print(f"same-pipeline baseline (m0/f0 -Sa, 1M chunks, 4-state): "
          f"total {base_total:,} B "
          f"({100 * (base_total / jam_total - 1):+.1f}% vs JAM = the "
          f"pipeline-mode cost alone)")

    print(f"\nGrid (bench pipeline m0/f0 -Sa, units=960): bytes and % vs "
          f"JAM default; steps = serial rANS steps, width = lockstep "
          f"chains")
    rows = []
    print(f"{'chunk':>6s} {'lanes':>5s} {'steps':>6s} {'width':>6s} "
          f"{'total(B)':>11s} {'vsJAM':>7s} {'vsBase':>7s} {'text':>7s}")
    for chunk in GRID_CHUNKS:
        for lanes in GRID_LANES:
            if lanes > chunk:  # degenerate split
                continue
            opt = _opt(chunk, lanes, mb=mb)
            total = 0
            per = {}
            for name, d in data.items():
                _, pay, _ = compress_block_ex(d, opt, ne)
                per[name] = len(pay)
                total += len(pay)
            rows.append({"chunk": chunk, "lanes": lanes,
                         "steps": chunk // lanes,
                         "width": (n // chunk) * lanes,
                         "total": total,
                         "vs_jam_pct": round(100 * (total / jam_total - 1),
                                             2),
                         "vs_base_pct": round(
                             100 * (total / base_total - 1), 2),
                         "text_vs_jam_pct": round(
                             100 * (per["text"] / jam["text"] - 1), 2),
                         "per": per})
            r = rows[-1]
            print(f"{chunk >> 10:>5d}K {lanes:>5d} {r['steps']:>6d} "
                  f"{r['width']:>6d} {total:>11,} {r['vs_jam_pct']:>+6.1f}% "
                  f"{r['vs_base_pct']:>+6.1f}% "
                  f"{r['text_vs_jam_pct']:>+6.1f}%")
    # units cost: anchors add 4*units bytes to the entropy-stage input
    print("\nunits dial at 64K x 128 (anchor bytes ride the entropy stage):")
    for units in (120, 960, 1920):
        opt = _opt(64 << 10, 128, units=units, mb=mb)
        total = 0
        for name, d in data.items():
            _, pay, _ = compress_block_ex(d, opt, ne)
            total += len(pay)
        print(f"  units={units:<5d} total {total:>11,} "
              f"({100 * (total / jam_total - 1):+.2f}% vs JAM)")
    out = {"mb": mb, "jam_total": jam_total, "jam_per": jam,
           "base_total": base_total, "base_per": base, "grid": rows}
    with open("build/ratio_frontier_sizes.json", "w") as f:
        json.dump(out, f)
    print("\nwritten: build/ratio_frontier_sizes.json")


def _sync(x):
    return int(np.asarray(x.ravel()[0]))


def _decode_compute(payload, blocksize, units, lanes, spans):
    from jampack_jax.runtime.metrics import fused_decode_compute_wall

    return fused_decode_compute_wall(payload, blocksize, units, lanes,
                                     spans)


def _encode_compute(data, opt):
    from jampack_jax.runtime.metrics import fused_encode_compute_wall

    return fused_encode_compute_wall(data, opt)


def speed(mb: int, configs=None):
    import jax

    from jampack_jax.runtime.device_decode import decode_block_device
    from jampack_jax.runtime.device_encode import encode_block_device
    from jampack_jax.runtime.engines import NativeEngine
    from jampack_jax.runtime.pipeline import Options, compress_block_ex

    n = (mb << 20) - ((mb << 20) % (120 * 16))
    data = textlike(n)
    ne = NativeEngine()
    # candidates informed by the sizes decomposition: the body cost is
    # ~45 B of model warmup PER CHAIN (chunks x lanes), so speed must be
    # bought with as few chains as hold the wall; rank's serial steps =
    # chunk bytes cap the chunk size
    configs = configs or [(8 << 10, 16), (8 << 10, 4), (8 << 10, 2),
                          (8 << 10, 0), (16 << 10, 4), (16 << 10, 8),
                          (64 << 10, 16)]
    print(f"{'chunk':>6s} {'lanes':>5s} {'bytes':>9s} {'dec(s)':>7s} "
          f"{'dGB/s':>7s} {'dcmp(s)':>7s} {'enc(s)':>7s} {'eMB/s':>7s} "
          f"{'ecmp(s)':>7s}")
    results = []
    for chunk, lanes in configs:
        opt = _opt(chunk, lanes, mb=mb)
        crc, payload, su = compress_block_ex(data, opt, ne)
        # decode: warmup + best-of-3 (e2e incl transfers, then compute)
        back = decode_block_device(payload, crc, opt.blocksize,
                                   opt.anchor_units, opt.rans_lanes, su)
        assert np.array_equal(back, data)
        td = min(_timed(lambda: decode_block_device(
            payload, crc, opt.blocksize, opt.anchor_units, opt.rans_lanes,
            su)) for _ in range(3))
        tdc = _decode_compute(payload, opt.blocksize, opt.anchor_units,
                              opt.rans_lanes, su)
        # encode (m3 store config, the fused-encode bench mode)
        eopt = Options(blocksize=n, filters=0, match_finder=3,
                       rans_lanes=lanes, ans_chunk=chunk, anchor_units=960,
                       lpx_spans=0)
        try:
            crc_e, pay_e = encode_block_device(data, eopt)
            ch, ph, _ = compress_block_ex(data, eopt, ne)
            assert (crc_e, pay_e) == (ch, ph)
            te = min(_timed(lambda: encode_block_device(data, eopt))
                     for _ in range(3))
            tec = _encode_compute(data, eopt)
        except Exception as e:  # noqa: BLE001
            te = tec = None
            print(f"  encode error: {e}")
        row = {"chunk": chunk, "lanes": lanes, "bytes": len(payload),
               "dec_s": round(td, 3), "dec_gbps": round(n / 1e9 / td, 5),
               "dec_compute_s": round(tdc, 3),
               "enc_s": None if te is None else round(te, 3),
               "enc_mbps": None if te is None else round(n / 1e6 / te, 2),
               "enc_compute_s": None if tec is None else round(tec, 3)}
        results.append(row)
        es = "-" if te is None else f"{te:7.2f}"
        ems = "-" if te is None else f"{row['enc_mbps']:7.2f}"
        ecs = "-" if tec is None else f"{tec:7.2f}"
        print(f"{chunk >> 10:>5d}K {lanes:>5d} {len(payload):>9,} "
              f"{td:>7.2f} {row['dec_gbps']:>7.5f} {tdc:>7.2f} {es:>7s} "
              f"{ems:>7s} {ecs:>7s}")
        with open("build/ratio_frontier_speed.json", "w") as f:
            json.dump({"mb": mb, "rows": results}, f)
    print("written: build/ratio_frontier_speed.json")


def _timed(fn):
    t0 = time.time()
    fn()
    return time.time() - t0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", action="store_true")
    ap.add_argument("--speed", action="store_true")
    ap.add_argument("--mb", type=int, default=8)
    args = ap.parse_args()
    if args.sizes:
        sizes(args.mb)  # host-only: native engine, no device
    if args.speed:
        speed(args.mb)
