"""Per-block codec pipeline and whole-archive compress/decompress.

Encode chain per block (jampack.cpp:30-42):
    checksum -> LZ77 dedupe -> filters -> Lpx -> LZ77 (configured mode)
    -> forward BWT -> entropy (rank/RLE0/rANS)
Decode runs the inverse chain and verifies the checksum (jampack.cpp:47-58).

This module is engine-agnostic: `Engine` is the executable-spec Python/numpy
engine; the native C++ engine and the device engine plug in with the same stage
interface (see native/, kernels/).
"""

import numpy as np

from ..format import checksum as _checksum
from ..format import framing
from ..format.constants import DEFAULT_BLOCKSIZE, MIN_BLOCKSIZE, MAX_BLOCKSIZE
from ..stages.ans import ans_decode, ans_encode
from ..stages.bwt import forward_bwt, inverse_bwt
from ..stages.filters import filters_decode, filters_encode
from ..stages.lpx import lpx_decode, lpx_encode
from ..stages.lz77 import lz77_decode, lz77_dedupe_encode


class Options:
    def __init__(self, blocksize=DEFAULT_BLOCKSIZE, match_finder=0, filters=1,
                 threads=1, multiblock=True, anchor_units=120,
                 ans_chunk=1 << 20, rans_lanes=0, lpx_spans=4,
                 lpx_auto=False):
        self.blocksize = int(min(max(blocksize, MIN_BLOCKSIZE), MAX_BLOCKSIZE))
        # 0..2 = the reference's finders (main.cpp:65-89 semantics);
        # 3 = "store" (framework extension): BOTH LZ stages emit a bare
        # end-token stream, so every stage length is a static function of
        # the block size — the mode the fused device encode runs in.
        self.match_finder = validate_match_finder(match_finder)
        self.filters = filters
        self.threads = threads
        self.multiblock = multiblock
        # native stream parameters; anchor_units != 120 or rans_lanes >= 2
        # switches the block framing to the JTX native container (framing.py)
        self.anchor_units = anchor_units
        self.ans_chunk = ans_chunk
        # Validate once at the boundary so header and payload always agree
        # across engines (the native encoder supports at most 4096 lanes).
        self.rans_lanes = validate_rans_lanes(rans_lanes)
        # Lpx sub-block count: 4 = reference split (lpx.cpp:150-169);
        # other values switch framing to the JT3 native container.  The
        # span count is the intra-block parallel width of the Lpx model.
        # 0 = skip the Lpx stage for every block (native container only).
        self.lpx_spans = validate_lpx_spans(lpx_spans)
        # lpx_auto: measure the Lpx stage's gain per block and write
        # lpx_spans=0 (stage skipped) into blocks where it earns nothing —
        # the decoder then skips its dominant serial-walk term.  Opt-in:
        # default-Options archives stay byte-identical to the reference.
        self.lpx_auto = bool(lpx_auto)


MAX_RANS_LANES = 4096
MAX_LPX_SPANS = 1 << 16
LZ_MODE_STORE = 3


def validate_match_finder(mode) -> int:
    mode = int(mode)
    if mode < 0 or mode > LZ_MODE_STORE:
        raise ValueError(f"match_finder {mode} out of range (0..3)")
    return mode


def validate_lpx_spans(spans) -> int:
    spans = int(spans)
    if spans < 0 or spans > MAX_LPX_SPANS:
        raise ValueError(f"lpx_spans {spans} out of range (0..{MAX_LPX_SPANS})")
    return spans


def validate_rans_lanes(lanes) -> int:
    """Single point of truth for the JTX lane-interleave range: 0 (classic
    4-state stream) or 2..MAX_RANS_LANES.  Values outside are rejected so no
    engine can frame a header that disagrees with its payload."""
    lanes = int(lanes)
    if lanes < 2:
        return 0
    if lanes > MAX_RANS_LANES:
        raise ValueError(
            f"rans_lanes {lanes} out of range (2..{MAX_RANS_LANES})"
        )
    return lanes


class Engine:
    """Executable-spec engine: pure Python/numpy stage implementations."""

    name = "numpy"

    def checksum(self, data) -> int:
        return _checksum.integrity_check(data)

    def lz_encode(self, data, mode: int):
        if mode == LZ_MODE_STORE:
            from ..stages.lz77 import lz77_store_encode

            return lz77_store_encode(data)
        if mode == 1:
            from ..stages.lz77_mf import lz77_m1_encode

            return lz77_m1_encode(data)
        if mode >= 2:
            from ..stages.lz77_mf import lz77_m2_encode

            return lz77_m2_encode(data)
        return lz77_dedupe_encode(data)

    def lz_decode(self, data, cap=None):
        return lz77_decode(data)

    def filters_encode(self, data, mode: int):
        return filters_encode(data, mode)

    def filters_decode(self, data):
        return filters_decode(data)

    def lpx_encode(self, data, spans=4):
        return lpx_encode(data, spans)

    def lpx_decode(self, data, spans=4):
        return lpx_decode(data, spans)

    def bwt_forward(self, data, units=120):
        return forward_bwt(data, units)

    def bwt_inverse(self, data, units=120):
        return inverse_bwt(data, units)

    def ans_encode(self, data, chunk=1 << 20, lanes=0):
        return ans_encode(data, chunk, lanes)

    def ans_decode(self, data, cap=None, lanes=0):
        return ans_decode(data, lanes=lanes)


# Lpx auto-gate threshold: keep the stage only when it zeroes at least
# NUM/DEN of the block's bytes (zeros feed RLE0 directly, so zeros-gained
# is the stage's whole downstream win).  INTEGER arithmetic — the device
# fused encode computes the same gate in int32 inside its jit
# (encode_stages.encode_front_core), so the comparison must be exactly
# shared.  Calibrated in round 4 against full both-ways encodes on eight
# 2 MB corpora (tools/lpx_gate_calib.py): kept corpora gain >= 0.28
# zeros-fraction (logs: 2.98x smaller with Lpx on); every gated-off corpus
# loses NOTHING by skipping — zeros and elf archives actually shrink
# 6.5% / 0.5% without the stage.  The asymmetric risk (skipping a big win)
# has margin 28x; the symmetric one (keeping a tiny loss, records at
# +0.14%) mirrors the reference's always-on choice.
LPX_AUTO_GAIN_NUM = 1
LPX_AUTO_GAIN_DEN = 100
LPX_AUTO_MIN_ZERO_GAIN = LPX_AUTO_GAIN_NUM / LPX_AUTO_GAIN_DEN  # for display


def _lpx_gain_gate(before: np.ndarray, after: np.ndarray) -> bool:
    """True when the Lpx stage earns its decode cost on this block."""
    if before.size == 0:
        return False
    gained = int(np.count_nonzero(after == 0)) - int(
        np.count_nonzero(before == 0))
    return gained * LPX_AUTO_GAIN_DEN >= before.size * LPX_AUTO_GAIN_NUM


def compress_block_ex(data: np.ndarray, opt: Options, engine=None):
    """Returns (crc, compressed_payload_bytes, lpx_spans_used).

    With opt.lpx_auto the Lpx stage is measured on this block and dropped
    (spans_used = 0) when its zero-gain is below LPX_AUTO_MIN_ZERO_GAIN;
    the caller must frame the block with the RETURNED span count."""
    eng = engine or Engine()
    data = np.asarray(data, dtype=np.uint8)
    crc = eng.checksum(data)
    # dedupe pre-pass: always mode 0 (jampack.cpp:34-36) except under the
    # store extension, which turns off both LZ stages
    pre = LZ_MODE_STORE if opt.match_finder == LZ_MODE_STORE else 0
    s = eng.lz_encode(data, pre)
    s = eng.filters_encode(s, opt.filters)
    spans = opt.lpx_spans
    if spans > 0:
        t = eng.lpx_encode(s, spans)
        if opt.lpx_auto and not _lpx_gain_gate(np.asarray(s), np.asarray(t)):
            spans = 0
        else:
            s = t
    s = eng.lz_encode(s, opt.match_finder)
    s = eng.bwt_forward(s, opt.anchor_units)
    payload = eng.ans_encode(s, opt.ans_chunk, opt.rans_lanes)
    return crc, bytes(payload), spans


def compress_block(data: np.ndarray, opt: Options, engine=None):
    """Returns (crc, compressed_payload_bytes).  Callers that frame blocks
    themselves must use compress_block_ex when opt.lpx_auto is set (the
    header's span word must match the encoder's per-block choice)."""
    crc, payload, spans = compress_block_ex(data, opt, engine)
    if spans != opt.lpx_spans:
        raise ValueError(
            "lpx_auto chose a different span count; use compress_block_ex")
    return crc, payload


def decompress_block(payload, crc: int, engine=None,
                     blocksize: int = DEFAULT_BLOCKSIZE,
                     units: int = 120, lanes: int = 0,
                     lpx_spans: int = 4) -> np.ndarray:
    eng = engine or Engine()
    # the reference sizes all stage buffers at 1.05x the block size
    cap = int(blocksize * 1.05) + 1024
    s = eng.ans_decode(np.frombuffer(payload, dtype=np.uint8), cap=cap,
                       lanes=lanes)
    s = eng.bwt_inverse(s, units)
    s = eng.lz_decode(s, cap=cap)
    if lpx_spans > 0:  # 0 = the encoder skipped the stage (framing.py)
        s = eng.lpx_decode(s, lpx_spans)
    s = eng.filters_decode(s)
    s = eng.lz_decode(s, cap=cap)
    out = np.asarray(s, dtype=np.uint8)
    if eng.checksum(out) != (crc & 0xFFFFFFFF):
        raise ValueError("detected corrupt block")
    return out


def compress_stream(inp, out, opt: Options = None, engine=None):
    """File-object to file-object archive compression.

    Replicates the reference's feof-driven read loop exactly
    (jampack.cpp:205-214): eof is only observed on a read PAST the data,
    so an input of K*blocksize bytes (including K = 0) compresses one
    extra EMPTY block — archive bytes are the contract."""
    opt = opt or Options()
    raw = comp = 0
    pending_empty = True  # empty input -> one empty block, like the ref
    while True:
        block = inp.read(opt.blocksize)
        data = np.frombuffer(block, dtype=np.uint8)
        if len(block) == 0 and not pending_empty:
            break
        crc, payload, spans = compress_block_ex(data, opt, engine)
        framing.write_block(out, crc, payload, opt.blocksize,
                            opt.anchor_units, opt.rans_lanes, spans)
        raw += len(block)
        comp += len(payload) + framing.HEADER_SIZE
        if len(block) == 0:
            break
        pending_empty = len(block) == opt.blocksize
    return raw, comp


def decompress_stream(inp, out, engine=None):
    raw = comp = 0
    while True:
        rec = framing.read_block(inp)
        if rec is None:
            break
        header, payload = rec
        data = decompress_block(payload, header.crc, engine,
                                header.blocksize, header.units, header.lanes,
                                header.lpx_spans)
        out.write(data.tobytes())
        comp += header.csize + framing.HEADER_SIZE
        raw += data.size
    return comp, raw
