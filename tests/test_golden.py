"""Golden-stream regression tests.

tests/fixtures/ holds archives produced by the compiled reference binary
(-f0/-f1/-f2/-m1/-m2 on a deterministic mixed-content input).  Every engine
must decode them bit-exactly forever — this pins the decode contract even
without the oracle binary present.  Additionally our default-settings
encoder must reproduce the reference's -f1 archive byte-for-byte.
"""

import io
import os

import numpy as np
import pytest

from jampack_jax.runtime.engines import NativeEngine, DeviceEngine
from jampack_jax.runtime.pipeline import (
    Engine,
    Options,
    compress_stream,
    decompress_stream,
)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def _read(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


GOLDEN_INPUT = _read("golden_input.bin")


@pytest.mark.parametrize("arc", ["golden_f0.jam", "golden_f1.jam",
                                 "golden_f2.jam", "golden_m1.jam",
                                 "golden_m2.jam"])
@pytest.mark.parametrize("engine_cls", [Engine, NativeEngine, DeviceEngine],
                         ids=["numpy", "native", "device"])
def test_every_engine_decodes_golden(arc, engine_cls):
    out = io.BytesIO()
    decompress_stream(io.BytesIO(_read(arc)), out, engine=engine_cls())
    assert out.getvalue() == GOLDEN_INPUT


@pytest.mark.parametrize("engine_cls", [Engine, NativeEngine],
                         ids=["numpy", "native"])
def test_default_encode_matches_reference_bytes(engine_cls):
    """Default -f1 encode reproduces the reference archive byte-for-byte."""
    arc = io.BytesIO()
    compress_stream(io.BytesIO(GOLDEN_INPUT), arc, Options(filters=1),
                    engine=engine_cls())
    assert arc.getvalue() == _read("golden_f1.jam")


@pytest.mark.parametrize("engine_cls", [Engine, NativeEngine, DeviceEngine],
                         ids=["numpy", "native", "device"])
def test_every_engine_decodes_golden_jtx(engine_cls):
    """JTX format lock: archive written at (u=960, L=16, c=256K) when the
    native container was finalized; every engine must decode it forever."""
    out = io.BytesIO()
    decompress_stream(io.BytesIO(_read("golden_jtx_u960_L16_c256.jtx")), out,
                      engine=engine_cls())
    assert out.getvalue() == GOLDEN_INPUT


def test_jtx_encoder_reproduces_golden_bytes():
    """JTX encode determinism: same options -> same bytes as the fixture."""
    arc = io.BytesIO()
    compress_stream(
        io.BytesIO(GOLDEN_INPUT), arc,
        Options(filters=1, anchor_units=960, ans_chunk=256 << 10,
                rans_lanes=16),
        engine=NativeEngine(),
    )
    assert arc.getvalue() == _read("golden_jtx_u960_L16_c256.jtx")


@pytest.mark.parametrize("mode", ["-m1", "-m2"])
def test_m1_m2_archives_match_reference_bytes(oracle, tmp_path, mode):
    """The anti-context match finders (m1 hash chain, m2 suffix array) must
    reproduce the reference's parsing decisions byte-for-byte — including
    the CHHM's never-updated PreviousValue quirk (cyclichhm.cpp:63)."""
    rng = np.random.default_rng(3)
    rec = np.zeros((5000, 24), np.uint8)
    rec[:, 0] = np.arange(5000) % 251
    rec[:, 1:9] = (np.arange(5000)[:, None] * np.arange(1, 9)[None, :]) % 256
    rec[:, 9:] = rng.integers(0, 12, (5000, 15))
    src = tmp_path / "struct.bin"
    src.write_bytes(rec.tobytes())

    ref_jam = tmp_path / "ref.jam"
    oracle.compress(src, ref_jam, mode, "-f1")

    arc = io.BytesIO()
    with open(src, "rb") as f:
        compress_stream(f, arc, Options(filters=1,
                                        match_finder=int(mode[2])),
                        engine=NativeEngine())
    assert arc.getvalue() == ref_jam.read_bytes()


@pytest.mark.parametrize("flags", [("-f0",), ("-f2",), ("-m1", "-f2")])
def test_flag_matrix_archives_match_reference_bytes(oracle, tmp_path, flags):
    """Distilled from the 42-combo sweep: encoder byte parity holds across
    filter and match-finder combinations on mixed content."""
    rng = np.random.default_rng(17)
    data = (
        ((np.arange(6000, dtype=np.int64) * 7) % 253).astype(np.uint8).tobytes()
        + bytes(rng.integers(0, 256, 20000, dtype=np.uint8))
        + b"the reference is the spec " * 800
        + bytes(8000)
    )
    src = tmp_path / "mix.bin"
    src.write_bytes(data)
    ref_jam = tmp_path / "ref.jam"
    oracle.compress(src, ref_jam, *flags)

    mf = next((int(f[2]) for f in flags if f.startswith("-m")), 0)
    fl = next((int(f[2]) for f in flags if f.startswith("-f")), 1)
    arc = io.BytesIO()
    with open(src, "rb") as f:
        compress_stream(f, arc, Options(filters=fl, match_finder=mf),
                        engine=NativeEngine())
    assert arc.getvalue() == ref_jam.read_bytes()


def test_m2_survives_input_that_segfaults_reference(oracle, tmp_path):
    """The reference's -m2 forward-match scan can run past its 1.05x buffer
    slack and segfault (observed on this exact input); our m2 bounds the
    scan by cpos (ppos < cpos) and must both survive and stay
    reference-decodable."""
    import subprocess

    rng = np.random.default_rng(17)
    data = (
        ((np.arange(6000, dtype=np.int64) * 7) % 253).astype(np.uint8).tobytes()
        + bytes(rng.integers(0, 256, 20000, dtype=np.uint8))
        + b"the reference is the spec " * 800
        + bytes(8000)
    )
    src = tmp_path / "mix.bin"
    src.write_bytes(data)

    arc = io.BytesIO()
    with open(src, "rb") as f:
        compress_stream(f, arc, Options(filters=1, match_finder=2),
                        engine=NativeEngine())
    out = io.BytesIO()
    decompress_stream(io.BytesIO(arc.getvalue()), out, engine=NativeEngine())
    assert out.getvalue() == data

    jam = tmp_path / "ours.jam"
    jam.write_bytes(arc.getvalue())
    back = tmp_path / "back.bin"
    oracle.decompress(jam, back)
    assert back.read_bytes() == data

    # document the reference behavior (skip silently if it was fixed)
    ref_jam = tmp_path / "ref.jam"
    proc = subprocess.run(
        [oracle.path, "c", str(src), str(ref_jam), "-m2", "-f1", "-t1"],
        capture_output=True,
    )
    assert proc.returncode != 0 or ref_jam.stat().st_size > 0


def test_heavy_quasi_rescale_matches_reference_bytes(oracle, tmp_path):
    """model.cpp:183 is unsigned arithmetic: chunks that push quasi models
    through large-scaled-count rescales must encode byte-identically (an
    earlier int32-wrap emulation refused them / mis-decoded)."""
    data = np.tile(np.arange(251, dtype=np.uint8), 800).tobytes()
    src = tmp_path / "q.bin"
    src.write_bytes(data)
    ref_jam = tmp_path / "ref.jam"
    oracle.compress(src, ref_jam, "-f0")
    arc = io.BytesIO()
    with open(src, "rb") as f:
        compress_stream(f, arc, Options(filters=0), engine=NativeEngine())
    assert arc.getvalue() == ref_jam.read_bytes()


def test_lpx_order_transition_matches_reference_bytes(oracle, tmp_path):
    """lpx.cpp re-derefs *order: after transitions the threshold update
    targets the new order's record; periodic stressors pin the behavior."""
    rng = np.random.default_rng(0)
    parts = []
    for p in (2, 3, 8, 5):
        parts.append(np.tile(rng.integers(0, 256, p, dtype=np.uint8),
                             40000 // p))
        parts.append(rng.integers(0, 256, 2000, dtype=np.uint8))
    data = np.concatenate(parts).tobytes()
    src = tmp_path / "p.bin"
    src.write_bytes(data)
    ref_jam = tmp_path / "ref.jam"
    oracle.compress(src, ref_jam, "-f1")
    arc = io.BytesIO()
    with open(src, "rb") as f:
        compress_stream(f, arc, Options(filters=1), engine=NativeEngine())
    assert arc.getvalue() == ref_jam.read_bytes()


def test_exact_multiple_trailing_empty_block(oracle, tmp_path):
    """feof semantics (jampack.cpp:205-214): an input of exactly K*blocksize
    bytes gets one trailing EMPTY block.  For K=0 our bytes match the
    reference exactly; for K>0 the reference's empty block encodes 480
    bytes of UNINITIALIZED buffer residue (bwt.cpp:37 never writes
    Indicies when nlen==0 — stale prior-block memory enters the stream),
    so parity there is structural: same block count, both archives decode
    in both directions (soft-parity class, like the filter-choice UB)."""
    import io
    import subprocess

    import numpy as np

    from jampack_jax.format import framing
    from jampack_jax.runtime.engines import NativeEngine
    from jampack_jax.runtime.pipeline import (Options, compress_stream,
                                              decompress_stream)

    ne = NativeEngine()
    rng = np.random.default_rng(3)
    for k in (0, 1, 2):
        data = rng.integers(0, 40, k << 20).astype(np.uint8).tobytes()
        src = tmp_path / f"in{k}.bin"
        src.write_bytes(data)
        arc = io.BytesIO()
        compress_stream(io.BytesIO(data), arc,
                        Options(blocksize=1 << 20), engine=ne)
        # trailing empty block present (k+1 blocks total)
        nblocks = 0
        bio = io.BytesIO(arc.getvalue())
        while framing.read_block(bio) is not None:
            nblocks += 1
        assert nblocks == k + 1
        # reference produces the same block count
        ref_arc = tmp_path / f"ref{k}.jam"
        oracle.compress(src, ref_arc, "-b1")
        rio = open(ref_arc, "rb")
        rblocks = 0
        while framing.read_block(rio) is not None:
            rblocks += 1
        assert rblocks == k + 1
        if k == 0:
            # fresh instance: zero-initialized anchors -> exact byte parity
            assert arc.getvalue() == ref_arc.read_bytes()
        # cross-decode both directions
        ours = tmp_path / f"ours{k}.jam"
        ours.write_bytes(arc.getvalue())
        dec = tmp_path / f"dec{k}.bin"
        oracle.decompress(ours, dec)
        assert dec.read_bytes() == data
        out = io.BytesIO()
        decompress_stream(open(ref_arc, "rb"), out, engine=ne)
        assert out.getvalue() == data


def test_m3_store_mode_golden_bytes(oracle, tmp_path):
    """-m3 (store) format lock: encode determinism against the fixture
    written when the mode was introduced, and the reference binary must
    decode it (the mode uses only reference-legal format elements)."""
    arc = io.BytesIO()
    compress_stream(io.BytesIO(GOLDEN_INPUT), arc,
                    Options(filters=1, match_finder=3),
                    engine=NativeEngine())
    assert arc.getvalue() == _read("golden_m3.jam")
    jam = tmp_path / "m3.jam"
    jam.write_bytes(arc.getvalue())
    out = tmp_path / "m3.out"
    oracle.decompress(jam, out, "-t1")
    assert out.read_bytes() == GOLDEN_INPUT


@pytest.mark.parametrize("engine_cls", [Engine, NativeEngine, DeviceEngine],
                         ids=["numpy", "native", "device"])
def test_every_engine_decodes_golden_jt3_prod(engine_cls):
    """JT3 production-config lock (round 5): archive written at the
    frontier-chosen stream (u=960, L=4, c=16K, -Sa — the config bench.py
    PROD_* prices); every engine must decode it forever."""
    out = io.BytesIO()
    decompress_stream(io.BytesIO(_read("golden_jt3_prod_u960_L4_c16_Sa.jt3")),
                      out, engine=engine_cls())
    assert out.getvalue() == GOLDEN_INPUT


def test_jt3_prod_encoder_reproduces_golden_bytes():
    """Production-config encode determinism incl. the -Sa gate choice."""
    arc = io.BytesIO()
    compress_stream(
        io.BytesIO(GOLDEN_INPUT), arc,
        Options(filters=1, anchor_units=960, ans_chunk=16 << 10,
                rans_lanes=4, lpx_spans=4096, lpx_auto=True),
        engine=NativeEngine(),
    )
    assert arc.getvalue() == _read("golden_jt3_prod_u960_L4_c16_Sa.jt3")
