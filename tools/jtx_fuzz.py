"""Cross-engine JTX fuzz: random corpora x random native stream parameters.

For each case: encode with the native engine under random (units, lanes,
chunk, filters, match finder, blocksize); every engine (spec / native /
device) must decode the archive back to the input, and the spec engine must
reproduce the native engine's bytes when re-encoding with the same options
(encoder determinism across implementations).

    python tools/jtx_fuzz.py [iterations] [seed0]
"""

import io
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# fuzz on the CPU backend unless the caller picks another
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from diff_fuzz import gen_input  # noqa: E402

from jampack_jax.runtime.engines import NativeEngine, DeviceEngine  # noqa: E402
from jampack_jax.runtime.pipeline import (  # noqa: E402
    Engine,
    Options,
    compress_stream,
    decompress_stream,
)


def one(seed: int) -> str:
    rng = np.random.default_rng(seed)
    data = gen_input(rng)[: int(rng.integers(1, 150_000))]
    opt = Options(
        blocksize=int(rng.choice([1, 8])) << 20,
        match_finder=int(rng.integers(0, 2)),
        filters=int(rng.integers(0, 3)),
        anchor_units=int(rng.choice([120, 240, 480, 960, 1920])),
        ans_chunk=int(rng.choice([32, 128, 512, 1024])) << 10,
        rans_lanes=int(rng.choice([0, 2, 4, 16, 64])),
        # 0 = Lpx stage skipped (round 4); lpx_auto gates per block
        lpx_spans=int(rng.choice([0, 1, 4, 16, 64, 960])),
        lpx_auto=bool(rng.integers(0, 2)),
    )
    arc = io.BytesIO()
    compress_stream(io.BytesIO(data), arc, opt, engine=NativeEngine())
    blob = arc.getvalue()

    for engine in (NativeEngine(), Engine(), DeviceEngine()):
        out = io.BytesIO()
        try:
            decompress_stream(io.BytesIO(blob), out, engine=engine)
        except Exception as e:
            return f"DECODE-RAISE seed={seed} engine={engine.name}: {e}"
        if out.getvalue() != data:
            return f"DECODE seed={seed} engine={engine.name}"

    if len(data) <= 40_000:  # spec encode is slow; keep cases small
        arc2 = io.BytesIO()
        compress_stream(io.BytesIO(data), arc2, opt, engine=Engine())
        if arc2.getvalue() != blob:
            return f"ENCODER-MISMATCH seed={seed}"

    # fused device encoder (store/filters-off config): byte parity with the
    # native engine per block under the same randomized stream parameters
    if len(data) >= 2048:
        from jampack_jax.runtime.device_encode import encode_block_device
        from jampack_jax.runtime.pipeline import compress_block

        dopt = Options(
            blocksize=opt.blocksize, match_finder=3, filters=0,
            anchor_units=min(opt.anchor_units, 240),
            ans_chunk=min(opt.ans_chunk, 32 << 10),
            rans_lanes=opt.rans_lanes, lpx_spans=opt.lpx_spans)
        # snap the block length to a small set: encode_block_core compiles
        # one variant per distinct n, and fuzz throughput dies re-compiling
        bn = max(s for s in (2048, 4096, 8192, 16384) if s <= len(data))
        block = np.frombuffer(data[:bn], dtype=np.uint8)
        try:
            got = encode_block_device(block, dopt)
        except NotImplementedError:
            got = None  # block below the device minimum
        except Exception as e:
            return f"DEVICE-ENCODE-RAISE seed={seed}: {e}"
        if got is not None and got != compress_block(block, dopt,
                                                     NativeEngine()):
            return f"DEVICE-ENCODE-MISMATCH seed={seed}"
    return ""


def main():
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 50
    seed0 = int(sys.argv[2]) if len(sys.argv) > 2 else 9_000_000
    fails = 0
    for i in range(iters):
        msg = one(seed0 + i)
        if msg:
            print(msg, flush=True)
            fails += 1
        if (i + 1) % 10 == 0:
            print(f"[{i + 1}/{iters}] {fails} divergences", flush=True)
    print(f"done: {iters} cases, {fails} divergences", flush=True)
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
