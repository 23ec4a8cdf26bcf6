"""Observability aux subsystem (SURVEY §5.1/§5.5)."""

import json
import os

import numpy as np

from jampack_jax.runtime.engines import NativeEngine
from jampack_jax.runtime.metrics import InstrumentedEngine, device_trace


def test_instrumented_engine_collects_per_stage_metrics():
    eng = InstrumentedEngine(NativeEngine())
    data = np.frombuffer(b"observability " * 2000, np.uint8)
    s = eng.lz_encode(data, 0)
    s = eng.filters_encode(s, 1)
    summary = eng.metrics.summary()
    assert "lz_encode" in summary and "filters_encode" in summary
    assert summary["lz_encode"]["MB"] > 0
    report = eng.metrics.report()
    assert "lz_encode" in report
    parsed = json.loads(eng.metrics.to_json())
    assert parsed["lz_encode"]["s"] >= 0


def test_device_trace_writes_profile(tmp_path):
    import jax.numpy as jnp

    logdir = str(tmp_path / "trace")
    with device_trace(logdir):
        x = jnp.arange(1024) * 2
        _ = int(x[0])
    found = any(
        name.endswith((".pb", ".json.gz", ".xplane.pb"))
        for _, _, files in os.walk(logdir)
        for name in files
    )
    assert found, "no profiler artifacts written"


def test_fused_compute_wall_helpers_smoke():
    """The bench's device-compute helpers (runtime/metrics.py) run the
    fused cores with pre-staged inputs; smoke them at tiny shapes on the
    CPU backend so bench.py's *_compute_* keys cannot rot silently."""
    import numpy as np

    from jampack_jax.runtime.engines import NativeEngine
    from jampack_jax.runtime.metrics import (fused_decode_compute_wall,
                                             fused_encode_compute_wall)
    from jampack_jax.runtime.pipeline import Options, compress_block_ex

    rng = np.random.default_rng(3)
    data = rng.integers(0, 8, 6000).astype(np.uint8)
    opt = Options(blocksize=1 << 20, filters=0, match_finder=3,
                  rans_lanes=4, ans_chunk=2048, anchor_units=16,
                  lpx_spans=0)
    crc, payload, su = compress_block_ex(data, opt, NativeEngine())
    td = fused_decode_compute_wall(payload, opt.blocksize,
                                   opt.anchor_units, opt.rans_lanes, su,
                                   trials=1)
    te = fused_encode_compute_wall(data, opt, trials=1)
    assert td > 0 and te > 0
