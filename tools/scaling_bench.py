"""Virtual-mesh scaling harness.

Measures the sharded full-decode path (runtime/sharding.py) at mesh sizes
1/2/4/8 on the virtual CPU backend, decoding the same archive each time.

The D virtual devices time-share the host's cores, so wall-clock cannot
show speedup; what CAN be measured honestly is the
sharding *overhead*: with perfect data parallelism the total work (and so
1-core wall time) is independent of D — any growth over the D=1 wall is
redundant work introduced by the mesh path (padding, collectives, batch
ragging).  overhead(D) = t(D)/t(1) - 1; the multi-host efficiency proxy is
1/(1+overhead): on real chips each device runs its share concurrently and
the only cross-device op is one psum scalar.

Usage: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       python tools/scaling_bench.py
Prints one JSON line.
"""

import io
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax

    from jampack_jax.runtime.pipeline import (Engine, Options,
                                              compress_stream)
    from jampack_jax.runtime.sharding import decode_archive_sharded, make_mesh

    rng = np.random.default_rng(17)
    n_dev = len(jax.devices())

    def make_blocks(uniform: bool):
        blocks = []
        for _ in range(8):
            n = 6000 if uniform else int(rng.integers(4000, 8000))
            rec = np.frombuffer(
                b"".join(bytes([i % 256, (i * 3) % 256, 7])
                         for i in range(n // 6)), dtype=np.uint8)
            blocks.append(np.concatenate(
                [rec, rng.integers(0, 6, n // 2).astype(np.uint8),
                 rec[:400].copy()]))
        return blocks

    class Chunked:
        def __init__(self, parts):
            self.parts = list(parts)
            self.i = 0

        def read(self, _):
            if self.i >= len(self.parts):
                return b""
            p = self.parts[self.i]
            self.i += 1
            return p.tobytes()

    opt = Options(blocksize=1 << 20, filters=2, match_finder=0, rans_lanes=4,
                  ans_chunk=2048, anchor_units=16)
    out = {}
    for label, uniform in (("uniform_blocks", True), ("ragged_blocks", False)):
        blocks = make_blocks(uniform)
        plain = b"".join(b.tobytes() for b in blocks)
        arc = io.BytesIO()
        compress_stream(Chunked(blocks), arc, opt, engine=Engine())
        raw = arc.getvalue()
        results = {}
        t1 = None
        for d in (1, 2, 4, 8):
            if d > n_dev:
                break
            mesh = make_mesh(d)
            got = decode_archive_sharded(io.BytesIO(raw), mesh)  # warm
            assert got == plain
            best = float("inf")
            for _ in range(3):
                t0 = time.time()
                got = decode_archive_sharded(io.BytesIO(raw), mesh)
                best = min(best, time.time() - t0)
            assert got == plain
            if d == 1:
                t1 = best
            results[f"mesh_{d}"] = {
                "wall_s": round(best, 3),
                "overhead_vs_1": round(best / t1 - 1, 4),
                "parallel_efficiency_proxy": round(t1 / best, 4),
            }
        out[label] = results

    # ---- encode direction: the sharded fused encode chain on uniform
    # blocks (the store/filters-off config it supports)
    from jampack_jax.runtime.sharding import encode_archive_sharded

    eopt = Options(blocksize=1 << 20, filters=0, match_finder=3,
                   rans_lanes=4, ans_chunk=2048, anchor_units=16,
                   lpx_spans=8)
    blocks = make_blocks(uniform=True)
    want = io.BytesIO()
    compress_stream(Chunked(blocks), want, eopt, engine=Engine())
    eresults = {}
    t1 = None
    for d in (1, 2, 4, 8):
        if d > n_dev:
            break
        mesh = make_mesh(d)
        arc = io.BytesIO()
        encode_archive_sharded(Chunked(blocks), arc, eopt, mesh)  # warm
        assert arc.getvalue() == want.getvalue()
        best = float("inf")
        for _ in range(3):
            arc = io.BytesIO()
            t0 = time.time()
            encode_archive_sharded(Chunked(blocks), arc, eopt, mesh)
            best = min(best, time.time() - t0)
        if d == 1:
            t1 = best
        eresults[f"mesh_{d}"] = {
            "wall_s": round(best, 3),
            "overhead_vs_1": round(best / t1 - 1, 4),
            "parallel_efficiency_proxy": round(t1 / best, 4),
        }
    out["encode_uniform_blocks"] = eresults

    print(json.dumps({
        "metric": "sharded_codec_mesh_overhead",
        "note": "1-core host: D virtual devices serialize; ideal wall is "
                "flat in D, so t(1)/t(D) proxies multi-host efficiency. "
                "Ragged batches pay the lockstep max-bound inflation; "
                "production streams have uniform full-size blocks.",
        "results": out,
    }))


if __name__ == "__main__":
    main()
