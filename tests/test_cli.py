"""CLI surface: flag parsing, JTX stream parameters survive the framing
(regression: the CLI used to drop -u/-L when writing block headers), and
full file roundtrips through the real entry point."""

import numpy as np
import pytest

from jampack_jax.cli import _parse, run

RNG = np.random.default_rng(7)


def test_parse_flags():
    mode, inp, outp, opt, engine = _parse(
        ["jam", "c", "a", "b", "-b16", "-m2", "-f2", "-t4",
         "-u960", "-c128", "-L8", "--engine=numpy"]
    )
    assert (mode, inp, outp) == ("c", "a", "b")
    assert opt.blocksize == 16 << 20
    assert opt.match_finder == 2 and opt.filters == 2 and opt.threads == 4
    assert opt.anchor_units == 960 and opt.ans_chunk == 128 << 10
    assert opt.rans_lanes == 8
    assert engine == "numpy"


def test_parse_refuses_in_place():
    with pytest.raises(SystemExit):
        _parse(["jam", "c", "same", "same"])


def _roundtrip(tmp_path, flags):
    data = (b"cli roundtrip " * 5000
            + bytes(RNG.integers(0, 256, 30000, dtype=np.uint8)))
    src = tmp_path / "in.bin"
    jam = tmp_path / "out.jam"
    back = tmp_path / "back.bin"
    src.write_bytes(data)
    run(["jam", "c", str(src), str(jam)] + flags)
    run(["jam", "d", str(jam), str(back)] + [f for f in flags if f.startswith("-t")])
    assert back.read_bytes() == data
    return jam.read_bytes()


def test_cli_roundtrip_default(tmp_path):
    blob = _roundtrip(tmp_path, ["-t2"])
    assert blob[:3] == b"JAM"


def test_cli_roundtrip_jtx_units_lanes(tmp_path):
    """Regression: -u/-L must reach the block framing and the decoder."""
    blob = _roundtrip(tmp_path, ["-u480", "-L8", "-c256", "-t2"])
    assert blob[:3] == b"JTX"


def test_cli_single_block_mode(tmp_path):
    _roundtrip(tmp_path, ["-T", "-b1"])


def test_cli_info(tmp_path, capsys):
    data = b"info header dump " * 4000
    src = tmp_path / "in.bin"; src.write_bytes(data)
    jam = tmp_path / "out.jam"
    run(["jam", "c", str(src), str(jam), "-u480", "-L4"])
    capsys.readouterr()
    run(["jam", "i", str(jam)])
    out = capsys.readouterr().out
    assert "JTX" in out and "units=480 lanes=4" in out
    assert "1 blocks" in out


def test_cli_fused_engine(tmp_path):
    """--engine fused: device-resident block-level encode+decode through
    the real CLI entry point; archive identical to the host engine's."""
    data = (b"fused engine cli " * 2500
            + bytes(RNG.integers(0, 256, 20000, dtype=np.uint8)))
    src = tmp_path / "in.bin"
    jam = tmp_path / "f.jam"
    jam2 = tmp_path / "h.jam"
    back = tmp_path / "back.bin"
    src.write_bytes(data)
    flags = ["-m3", "-f0", "-u16", "-L4", "-c2", "-S8"]
    run(["jam", "c", str(src), str(jam), "--engine=fused"] + flags)
    run(["jam", "c", str(src), str(jam2), "--engine=numpy"] + flags)
    assert jam.read_bytes() == jam2.read_bytes()
    run(["jam", "d", str(jam), str(back), "--engine=fused"])
    assert back.read_bytes() == data


def test_default_engine_is_native():
    """The default engine is pinned to `native`, which needs no
    accelerator; a change of default follows a measurement of the
    engines on the GPU."""
    _, _, _, _, engine = _parse(["jam", "d", "a", "b"])
    assert engine == "native"


def test_parse_b_preserves_span_flags():
    """-b rebuilds nothing: stream parameters set by earlier flags (-S#,
    -Sa) survive regardless of flag order (ADVICE r4 low)."""
    _, _, _, opt, _ = _parse(["jam", "c", "a", "b", "-Sa", "-S8", "-b16"])
    assert opt.blocksize == 16 << 20
    assert opt.lpx_spans == 8 and opt.lpx_auto is True
    _, _, _, opt, _ = _parse(["jam", "c", "a", "b", "-b16", "-S0"])
    assert opt.blocksize == 16 << 20 and opt.lpx_spans == 0


def test_parse_rejects_unknown_flags():
    """Unrecognized option characters fail loudly instead of being
    silently dropped ('-S4a' used to discard the trailing 'a')."""
    with pytest.raises(SystemExit):
        _parse(["jam", "c", "a", "b", "-S4a"])
    with pytest.raises(SystemExit):
        _parse(["jam", "c", "a", "b", "-x3"])
    with pytest.raises(SystemExit):
        _parse(["jam", "c", "a", "b", "--frobnicate"])
    # -v / --verbose stay accepted (handled in run())
    _parse(["jam", "c", "a", "b", "-v"])
    _parse(["jam", "c", "a", "b", "--verbose"])
