"""Engine-parameterized pipeline tests: every engine must agree bit-exactly."""

import io

import numpy as np
import pytest

from jampack_jax.runtime.engines import DeviceEngine
from jampack_jax.runtime.pipeline import (
    Engine,
    Options,
    compress_block,
    compress_stream,
    decompress_block,
    decompress_stream,
)

RNG = np.random.default_rng(321)


def engines():
    yield Engine()
    yield DeviceEngine()


@pytest.mark.parametrize("engine", list(engines()), ids=lambda e: e.name)
def test_engine_roundtrip(engine):
    data = np.concatenate(
        [
            RNG.integers(0, 256, 30000, dtype=np.uint8),
            np.zeros(10000, dtype=np.uint8),
            np.frombuffer(b"structured text pattern " * 1000, dtype=np.uint8),
        ]
    ).tobytes()
    arc = io.BytesIO()
    compress_stream(io.BytesIO(data), arc, Options(filters=1), engine=engine)
    back = io.BytesIO()
    decompress_stream(io.BytesIO(arc.getvalue()), back, engine=engine)
    assert back.getvalue() == data


def test_engines_cross_decode_each_other():
    # DeviceEngine makes its own (equally valid) filter choices, so archives
    # may differ; every engine must decode every engine's archive.
    data = np.frombuffer(b"interop check " * 3000, dtype=np.uint8).tobytes()
    arcs = []
    for engine in engines():
        arc = io.BytesIO()
        compress_stream(io.BytesIO(data), arc, Options(filters=1), engine=engine)
        arcs.append(arc.getvalue())
    for arc in arcs:
        for engine in engines():
            out = io.BytesIO()
            decompress_stream(io.BytesIO(arc), out, engine=engine)
            assert out.getvalue() == data


def test_store_mode_reference_decodable(oracle, tmp_path):
    """-m3 (store, framework extension) archives use only format elements
    the reference understands: its binary must decode them bit-exactly."""
    rng = np.random.default_rng(99)
    data = (b"store mode block " * 2000
            + bytes(rng.integers(0, 256, 30000, dtype=np.uint8)))
    jam = tmp_path / "m3.jam"
    with open(jam, "wb") as f:
        compress_stream(io.BytesIO(data), f,
                        Options(match_finder=3, filters=1))
    out = tmp_path / "m3.out"
    oracle.decompress(jam, out, "-t1")
    assert out.read_bytes() == data


def test_match_finder_validation():
    with pytest.raises(ValueError):
        Options(match_finder=4)
    with pytest.raises(ValueError):
        Options(match_finder=-1)


def test_cross_engine_decode(oracle, tmp_path):
    data = np.frombuffer(b"cross engine decode " * 2500, dtype=np.uint8).tobytes()
    raw = tmp_path / "in.bin"
    jam = tmp_path / "a.jam"
    raw.write_bytes(data)
    oracle.compress(raw, jam)
    for engine in engines():
        out = io.BytesIO()
        with open(jam, "rb") as f:
            decompress_stream(f, out, engine=engine)
        assert out.getvalue() == data


def test_device_filter_search_mode_f3():
    """-f3: device-batched config search; still reference-format chunks."""
    import io

    from jampack_jax.runtime.engines import DeviceEngine
    from jampack_jax.runtime.pipeline import (
        Options,
        compress_stream,
        decompress_stream,
    )

    rng = np.random.default_rng(3)
    base = np.arange(0, 24000, 3, dtype=np.int64) % 251
    data = (base + rng.integers(0, 2, base.size)).astype(np.uint8).tobytes()
    arc = io.BytesIO()
    compress_stream(io.BytesIO(data), arc, Options(filters=3),
                    engine=DeviceEngine())
    back = io.BytesIO()
    decompress_stream(io.BytesIO(arc.getvalue()), back)
    assert back.getvalue() == data


def test_hybrid_engine_roundtrip_and_interop(monkeypatch):
    import io

    from jampack_jax.runtime import sysinfo
    from jampack_jax.runtime.engines import HybridEngine, NativeEngine

    # stand the CPU device in for an accelerator and force the device-fit
    # gate open, so the device BWT kernels are exercised on the CPU test
    # backend (the engine refuses to start without an accelerator)
    import jax

    monkeypatch.setattr(sysinfo, "accelerator_devices",
                        lambda: jax.devices()[:1])
    monkeypatch.setattr(sysinfo, "fits_on_device", lambda n, budget=0.8: True)

    rng = np.random.default_rng(11)
    data = (b"hybrid engine " * 3000
            + bytes(rng.integers(0, 256, 50000, dtype=np.uint8)))
    arc = io.BytesIO()
    compress_stream(io.BytesIO(data), arc, Options(filters=1),
                    engine=HybridEngine())
    # native-encoded bytes must be identical (same stages, BWT is canonical)
    arc2 = io.BytesIO()
    compress_stream(io.BytesIO(data), arc2, Options(filters=1),
                    engine=NativeEngine())
    assert arc.getvalue() == arc2.getvalue()
    out = io.BytesIO()
    decompress_stream(io.BytesIO(arc.getvalue()), out, engine=HybridEngine())
    assert out.getvalue() == data


def test_hybrid_engine_needs_an_accelerator():
    from jampack_jax.runtime.engines import HybridEngine

    with pytest.raises(RuntimeError, match="needs an accelerator"):
        HybridEngine()


@pytest.mark.parametrize("match_finder", [0, 1, 2, 3])
@pytest.mark.parametrize("filters", [0, 1, 2])
def test_spec_native_identical_archives_all_options(match_finder, filters):
    """The spec engine must produce byte-identical archives to the native
    engine for EVERY Options — no silent m1/m2 downgrade (lz77.cpp:278-441
    parity now lives in stages/lz77_mf.py)."""
    from jampack_jax.runtime.engines import NativeEngine

    rng = np.random.default_rng(1234)
    data = np.concatenate([
        np.frombuffer(b"structured record " * 400, dtype=np.uint8),
        rng.integers(0, 6, 4000, dtype=np.uint8),
        np.frombuffer(b"".join(bytes([i % 256, (i * 3) % 256, 7])
                               for i in range(1500)), dtype=np.uint8),
    ])
    opt = Options(match_finder=match_finder, filters=filters)
    crc_s, pay_s = compress_block(data, opt, Engine())
    crc_n, pay_n = compress_block(data, opt, NativeEngine())
    assert crc_s == crc_n
    assert pay_s == pay_n
    back = decompress_block(pay_s, crc_s, Engine())
    assert np.array_equal(back, data)
