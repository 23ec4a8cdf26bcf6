"""Engine implementations for the block pipeline.

- Engine (runtime.pipeline): pure Python/numpy executable spec.
- DeviceEngine: BWT forward/inverse and rANS symbol decode on device via the
  JAX/XLA kernels; remaining serial transforms on host (the native C++
  engine takes those over — see native/).
"""

import numpy as np

from ..runtime.pipeline import Engine
from ..stages.ans import read_chunk_header
from ..stages.rank import rank_decode
from ..stages.rle0 import rle0_decode


class NativeEngine(Engine):
    """Host C++ engine (native/): the fast encode path and the CPU
    decode baseline.  Same stream contract as the spec engine."""

    name = "native"

    def __init__(self, threads: int = 0):
        from .. import native

        self._n = native
        self.threads = threads

    def checksum(self, data):
        return self._n.checksum(data)

    def lz_encode(self, data, mode: int):
        from .pipeline import LZ_MODE_STORE

        if mode == LZ_MODE_STORE:
            from ..stages.lz77 import lz77_store_encode

            return lz77_store_encode(data)  # trivial; no native leg needed
        return self._n.lz_encode(data, mode)

    def lz_decode(self, data, cap=None):
        cap = cap or (np.asarray(data).size * 4 + (1 << 20))
        return self._n.lz_decode(data, cap)

    def filters_encode(self, data, mode: int):
        return self._n.filters_encode(data, mode, self.threads)

    def filters_decode(self, data):
        return self._n.filters_decode(data)

    def lpx_encode(self, data, spans=4):
        return self._n.lpx_encode(data, self.threads, spans)

    def lpx_decode(self, data, spans=4):
        return self._n.lpx_decode(data, self.threads, spans)

    def bwt_forward(self, data, units=120):
        return self._n.bwt_forward(data, units)

    def bwt_inverse(self, data, units=120):
        return self._n.bwt_inverse(data, self.threads, units)

    def ans_encode(self, data, chunk=1 << 20, lanes=0):
        return self._n.ans_encode(data, chunk, lanes)

    def ans_decode(self, data, cap=None, lanes=0):
        cap = cap or (np.asarray(data).size * 8 + (1 << 20))
        return self._n.ans_decode(data, cap, self.threads, lanes)


class HybridEngine(NativeEngine):
    """Native C++ host engine for the irreducibly serial stages (entropy
    chains, rank/RLE, Lpx, LZ match finding) and the device kernels for
    the BWT — the stage whose suffix sort / LF chase are the FLOP- and
    bandwidth-heavy parts that map onto the device.  Needs an accelerator:
    constructing it on a CPU-only backend raises."""

    name = "hybrid"

    def __init__(self, threads: int = 0):
        from . import sysinfo

        if not sysinfo.accelerator_devices():
            raise RuntimeError("the hybrid engine needs an accelerator; "
                               "JAX found none")
        super().__init__(threads)

    def _device_fits(self, nbytes: int) -> bool:
        # the reference's GPU-offload gate (bwt.cpp:102-114): ~6 bytes of
        # working set per input byte must fit in 80% of device memory
        from . import sysinfo

        return sysinfo.fits_on_device(nbytes)

    def bwt_forward(self, data, units=120):
        if not self._device_fits(np.asarray(data).size):
            return super().bwt_forward(data, units)
        from ..kernels.sa import forward_bwt_device

        return forward_bwt_device(data, units)

    def bwt_inverse(self, data, units=120):
        if not self._device_fits(np.asarray(data).size):
            return super().bwt_inverse(data, units)
        from ..kernels.ibwt import inverse_bwt_device

        return inverse_bwt_device(data, units)


class DeviceEngine(Engine):
    name = "device"

    def lz_decode(self, data, cap=None):
        from ..kernels.lz_expand import lz77_decode_device

        return lz77_decode_device(data)

    def lpx_encode(self, data, spans=4):
        from ..kernels.lpx_device import lpx_encode_device

        return lpx_encode_device(data, spans)

    def lpx_decode(self, data, spans=4):
        from ..kernels.lpx_device import lpx_decode_device

        return lpx_decode_device(data, spans)

    def filters_encode(self, data, mode: int):
        if mode == 1:
            # device sorted-entropy scoring of the stride/projection
            # candidates (survey P8); archives byte-identical to native -f1
            from ..kernels.filters_search import filters_encode_f1_device

            return filters_encode_f1_device(data)
        if mode == 2:
            # all 96 configs swept on device (one-hot histograms);
            # near-tie picks re-scored in f64 => byte-identical to -f2
            from ..kernels.filters_search import filters_encode_f2_device

            return filters_encode_f2_device(data)
        if mode < 1:
            return super().filters_encode(data, mode)
        # -f3: device-batched config search (survey P8), inline-delta
        # transforms on device; emits the same (type,width) chunk format
        # (still reference-decodable)
        from ..format.constants import FILTER_BLOCK_SIZE
        from ..kernels.filters import inline_delta_device, pick_config_device

        import jax.numpy as jnp

        data = np.asarray(data, dtype=np.uint8)
        out = bytearray()
        for i in range(0, data.size, FILTER_BLOCK_SIZE):
            chunk = data[i : i + FILTER_BLOCK_SIZE]
            ftype, width = pick_config_device(chunk)
            out.append(ftype if width else 0)
            out.append(width)
            if width:
                out += np.asarray(
                    inline_delta_device(jnp.asarray(chunk), width, chunk.size)
                ).tobytes()
            else:
                out += chunk.tobytes()
        return np.frombuffer(bytes(out), dtype=np.uint8)

    def filters_decode(self, data):
        from ..format.constants import FILTER_BLOCK_SIZE, FILTER_MAX_TYPES, FILTER_MAX_WIDTH
        from ..kernels.filters import inline_undelta_device
        from ..stages.filters import _unapply

        import jax.numpy as jnp

        data = np.asarray(data, dtype=np.uint8)
        out = []
        i = 0
        n = data.size
        while i < n:
            ftype = int(data[i])
            width = int(data[i + 1])
            i += 2
            if ftype >= FILTER_MAX_TYPES or width > FILTER_MAX_WIDTH:
                raise ValueError("unsupported filter configuration")
            ln = FILTER_BLOCK_SIZE if (i + FILTER_BLOCK_SIZE) < n else (n - i)
            chunk = data[i : i + ln]
            if ftype == 2 and width > 0:
                out.append(np.asarray(inline_undelta_device(jnp.asarray(chunk), width, ln)))
            else:
                out.append(_unapply(chunk, ftype, width))
            i += ln
        return np.concatenate(out) if out else np.zeros(0, dtype=np.uint8)

    def bwt_forward(self, data, units=120):
        from ..kernels.sa import forward_bwt_device

        return forward_bwt_device(data, units)

    def bwt_inverse(self, data, units=120):
        from ..kernels.ibwt import inverse_bwt_device

        return inverse_bwt_device(data, units)

    def ans_encode(self, data, chunk=1 << 20, lanes=0):
        from ..format.constants import ANS_CHUNK_SIZE
        from ..format.varint import encode_leb128
        from ..kernels.rans_encode import encode_lanes_device, encode_pairs_device
        from ..stages.ans import write_chunk_header
        from ..stages.rank import rank_encode
        from ..stages.rle0 import rle0_encode

        data = np.asarray(data, dtype=np.uint8)
        chunk = min(max(int(chunk), 1), ANS_CHUNK_SIZE)
        out = bytearray()
        for base in range(0, data.size, chunk):
            part = data[base : base + chunk].copy()
            ranked, freqs = rank_encode(part)
            syms = rle0_encode(ranked)
            rlen = int(syms.size)
            if lanes >= 2:
                payloads = encode_lanes_device([syms[l::lanes] for l in range(lanes)])
                table = b"".join(encode_leb128(len(p)) for p in payloads)
                payload = table + b"".join(payloads)
            else:
                payload = encode_pairs_device(syms)
            out += write_chunk_header(freqs, part.size, len(payload), rlen)
            out += payload
        return bytes(out)

    def ans_decode(self, data, cap=None, lanes=0):
        """Chunk-grid entropy decode (survey P5 + P6): every independent
        chain in the stream — one per chunk in the reference layout, one
        per chunk x lane in JTX wide-interleave — decodes in a single
        vmapped lockstep kernel call."""
        from ..kernels.rans_decode import decode_lanes_device
        from ..stages.ans import interleave_lanes, lane_rlen, read_lane_table

        buf = np.asarray(data, dtype=np.uint8)
        view = memoryview(buf.tobytes())
        pos = 0
        chunks = []  # (freqs, olen, rlen, [chain rows])
        starts, rlens = [], []
        while pos < len(view):
            freqs, olen, clen, rlen, pos = read_chunk_header(view, pos)
            if lanes >= 2:
                lane_clens, p = read_lane_table(view, pos, rlen, lanes)
                if sum(lane_clens) != clen - (p - pos):
                    raise ValueError("corrupt lane table")
                rows = list(range(len(starts), len(starts) + lanes))
                starts.extend(np.cumsum([p] + lane_clens[:-1]).tolist())
                rlens.extend(lane_rlen(rlen, lanes, l) for l in range(lanes))
            else:
                rows = [len(starts)]
                starts.append(pos)
                rlens.append(rlen)
            chunks.append((freqs, olen, rlen, rows))
            pos += clen
        if not chunks:
            return np.zeros(0, dtype=np.uint8)

        all_syms = decode_lanes_device(
            buf,
            np.asarray(starts, dtype=np.int32),
            np.asarray(rlens, dtype=np.int32),
        )
        parts = []
        for freqs, olen, rlen, rows in chunks:
            if lanes >= 2:
                syms = interleave_lanes(
                    [all_syms[r, : rlens[r]] for r in rows], rlen, lanes
                )
            else:
                syms = all_syms[rows[0], :rlen]
            ranked = rle0_decode(syms, olen)
            parts.append(rank_decode(ranked, freqs))
        return np.concatenate(parts)
