"""Multi-host work division: P simulated hosts decode disjoint block sets,
stitch() reassembles the original file in block order."""

import io

import numpy as np
import pytest

from jampack_jax.runtime.distributed import (
    decompress_stream_part,
    initialize,
    owner,
    stitch,
)
from jampack_jax.runtime.engines import NativeEngine
from jampack_jax.runtime.pipeline import Options, compress_stream

RNG = np.random.default_rng(42)


def test_owner_partition_is_total_and_disjoint():
    P = 4
    owners = [owner(i, P) for i in range(100)]
    assert set(owners) == set(range(P))
    assert all(0 <= o < P for o in owners)


@pytest.mark.parametrize("P", [1, 2, 3])
def test_multihost_decode_stitch(tmp_path, P):
    data = (b"multi host block stream " * 8000
            + bytes(RNG.integers(0, 256, 120000, dtype=np.uint8)))
    arc = io.BytesIO()
    compress_stream(io.BytesIO(data), arc,
                    Options(filters=0, blocksize=1 << 20),
                    engine=NativeEngine())
    blob = arc.getvalue()

    initialize()  # single-process no-op
    out_dir = str(tmp_path / "parts")
    for p in range(P):  # simulate P hosts sequentially
        decompress_stream_part(io.BytesIO(blob), out_dir, p, P,
                               engine=NativeEngine())
    out_path = str(tmp_path / "restored.bin")
    total = stitch(out_dir, out_path, P)
    assert total == len(data)
    assert open(out_path, "rb").read() == data


@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("tail", ["ragged", "exact"])
def test_multihost_encode_stitch(tmp_path, P, tail):
    """P simulated hosts compress disjoint raw-block sets from a seekable
    input; stitch_archive() reassembles a framed archive byte-identical to
    the single-process compress_stream's (including the trailing-empty-
    block feof parity when the input is an exact blocksize multiple)."""
    from jampack_jax.runtime.distributed import (
        compress_stream_part,
        stitch_archive,
    )

    bs = 1 << 20
    n = 3 * bs if tail == "exact" else 3 * bs + 70000
    data = (b"multi host encode " * (n // 18 + 1))[:n]
    opt = Options(filters=1, blocksize=bs)

    want = io.BytesIO()
    compress_stream(io.BytesIO(data), want, opt, engine=NativeEngine())

    out_dir = str(tmp_path / "aparts")
    for p in range(P):  # simulate P hosts sequentially
        compress_stream_part(io.BytesIO(data), len(data), out_dir, p, P,
                             opt, engine=NativeEngine())
    out_path = str(tmp_path / "stitched.jam")
    total = stitch_archive(out_dir, out_path, P)
    got = open(out_path, "rb").read()
    assert total == len(got)
    assert got == want.getvalue()
