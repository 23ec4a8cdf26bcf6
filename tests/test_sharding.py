"""Multi-chip (virtual 8-device CPU mesh) sharded codec step tests."""

import numpy as np
import pytest

import jax

from jampack_jax.runtime.sharding import make_mesh, roundtrip_blocks


def test_mesh_has_8_virtual_devices():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_sharded_roundtrip(n_devices):
    mesh = make_mesh(n_devices)
    rng = np.random.default_rng(7)
    blocks = rng.integers(0, 256, (n_devices * 2, 120 * 8), dtype=np.uint8)
    recon, bwt, metric = roundtrip_blocks(blocks, mesh)
    assert np.array_equal(recon, blocks)
    # psum'd metric equals the host-side total over all blocks' BWTs
    assert metric == int(bwt.astype(np.uint64).sum())


def test_graft_entry():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = fn(*args)
    assert np.array_equal(np.asarray(out[0]), args[0])
    g.dryrun_multichip(8)


def test_encode_archive_sharded_straggler_auto_static_corner():
    """A single straggler block under lpx_auto in the static-split Lpx
    corner runs the static-split chain with its on-device gate, and the
    archive equals the host encoder's per-block choices.  n=4096 with
    spans=96 hits the corner (n2 remainder > span base length); two
    blocks of different lengths make each a single-straggler group."""
    import io

    import numpy as np

    from jampack_jax.format import framing
    from jampack_jax.runtime.pipeline import (Engine, Options,
                                              compress_stream)
    from jampack_jax.runtime.sharding import (decode_archive_sharded,
                                              encode_archive_sharded,
                                              make_mesh)

    rng = np.random.default_rng(11)
    blocks = [rng.integers(0, 8, 4096).astype(np.uint8),
              rng.integers(0, 8, 2048).astype(np.uint8)]

    class _Chunked:
        def __init__(self, parts):
            self.parts = list(parts)
            self.i = 0

        def read(self, _sz):
            if self.i >= len(self.parts):
                return b""
            p = self.parts[self.i]
            self.i += 1
            return p.tobytes()

    opt = Options(blocksize=1 << 20, filters=0, match_finder=3,
                  rans_lanes=4, ans_chunk=2048, anchor_units=16,
                  lpx_spans=96, lpx_auto=True)
    mesh = make_mesh()
    arc = io.BytesIO()
    encode_archive_sharded(_Chunked(blocks), arc, opt, mesh)
    harc = io.BytesIO()
    compress_stream(_Chunked(blocks), harc, opt, engine=Engine())
    assert arc.getvalue() == harc.getvalue()
    plain = b"".join(b.tobytes() for b in blocks)
    assert decode_archive_sharded(io.BytesIO(arc.getvalue()), mesh) == plain


def test_sharded_routes_count_device_blocks():
    """Every block at or above the device minimum runs on the device; only
    a tail below it takes the host engine, and is counted as such."""
    import io
    from collections import Counter

    import numpy as np

    from jampack_jax.runtime.pipeline import Options
    from jampack_jax.runtime.sharding import (decode_archive_sharded,
                                              encode_archive_sharded,
                                              make_mesh)

    rng = np.random.default_rng(5)
    parts = [rng.integers(0, 12, 6000).astype(np.uint8) for _ in range(3)]
    parts.append(rng.integers(0, 12, 700).astype(np.uint8))  # < 1024

    class _Chunked:
        def __init__(self, ps):
            self.ps = list(ps)

        def read(self, _sz):
            return self.ps.pop(0).tobytes() if self.ps else b""

    opt = Options(blocksize=1 << 20, filters=0, match_finder=3,
                  rans_lanes=4, ans_chunk=2048, anchor_units=16,
                  lpx_spans=8)
    mesh = make_mesh(2)
    enc, dec = Counter(), Counter()
    arc = io.BytesIO()
    encode_archive_sharded(_Chunked(parts), arc, opt, mesh, routes=enc)
    assert enc == {"device": 3, "host:small": 1}
    back = decode_archive_sharded(io.BytesIO(arc.getvalue()), mesh,
                                  routes=dec)
    assert back == b"".join(p.tobytes() for p in parts)
    assert dec == {"device": 4}
