"""Randomized cross-option property sweep: encode with one engine/config,
decode with every engine, compare bytes.  The format matrix is the
contract; this is the shotgun behind the targeted tests."""

import io

import numpy as np
import pytest

from jampack_jax.runtime.engines import NativeEngine, DeviceEngine
from jampack_jax.runtime.pipeline import (
    Engine,
    Options,
    compress_stream,
    decompress_stream,
)

RNG = np.random.default_rng(1234)


def _mixed_input(n):
    """Structured + textual + random + runs, glued."""
    parts = []
    base = np.arange(0, n, 1, dtype=np.int64)
    parts.append(((base * 7) % 253).astype(np.uint8)[: n // 4])  # stride
    parts.append(np.frombuffer(
        (b"jam jam jampack jax stream " * (n // 100 + 1))[: n // 4], np.uint8))
    parts.append(RNG.integers(0, 256, n // 4, dtype=np.uint8))  # noise
    parts.append(np.zeros(n - 3 * (n // 4), dtype=np.uint8))  # runs
    return np.concatenate(parts).tobytes()


CONFIGS = [
    Options(filters=0, match_finder=0),
    Options(filters=1, match_finder=1),
    Options(filters=2, match_finder=2, ans_chunk=64 << 10),
    Options(filters=1, anchor_units=360, rans_lanes=4),
    Options(filters=0, anchor_units=1920, rans_lanes=32, ans_chunk=256 << 10),
    Options(filters=1, blocksize=1 << 20),  # multi-block
]


@pytest.mark.parametrize("cfg", range(len(CONFIGS)))
def test_cross_engine_matrix(cfg):
    opt = CONFIGS[cfg]
    data = _mixed_input(3 << 20 if opt.blocksize < (8 << 20) else 300_000)
    arc = io.BytesIO()
    compress_stream(io.BytesIO(data), arc, opt, engine=NativeEngine())
    blob = arc.getvalue()
    for engine in (NativeEngine(), DeviceEngine()):
        out = io.BytesIO()
        decompress_stream(io.BytesIO(blob), out, engine=engine)
        assert out.getvalue() == data, (cfg, engine.name)


def test_spec_engine_one_config():
    """The pure-Python engine is slow; one small config keeps it honest."""
    opt = Options(filters=1, rans_lanes=2, anchor_units=240)
    data = _mixed_input(60_000)
    arc = io.BytesIO()
    compress_stream(io.BytesIO(data), arc, opt, engine=Engine())
    for engine in (Engine(), NativeEngine(), DeviceEngine()):
        out = io.BytesIO()
        decompress_stream(io.BytesIO(arc.getvalue()), out, engine=engine)
        assert out.getvalue() == data
