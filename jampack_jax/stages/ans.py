"""Entropy stage: SRC rank -> RLE0 -> structured 4-way interleaved rANS.

Per 1 MB chunk (model state resets at every chunk boundary, making chunks
independently decodable — the parallel-decode unit of the format):

  1. models reset (1 exponent AdaptiveModel + 2 adaptive + 6 quasi mantissa),
  2. rank transform, RLE0 to 16-bit symbols,
  3. each symbol split into exponent + mantissa, two (low,freq) pairs pushed
     through the models in forward order,
  4. pairs encoded in reverse through 4 interleaved rANS states rotating
     R0->R3, flushed R3..R0 (16 bytes of state),
  5. chunk header: 256 LEB128 rank freqs + olen + clen + rlen.

This module is the slow, obviously-correct executable spec; the native C++
engine (native/) and the device kernels (kernels/) are validated against it.

Reference behavior: ans.cpp:14-302.
"""

import numpy as np

from ..format.constants import (
    ANS_CHUNK_SIZE,
    MAX_MODELS,
    MODEL_SWITCH_THRESHOLD,
    PROB_BITS,
    RANS_BYTE_L,
)
from ..format.tables import EXPONENT, LOG, MANTISSA
from ..format.varint import decode_leb128, encode_leb128
from .models import AdaptiveModel, QuasiModel
from .rank import rank_decode, rank_encode
from .rle0 import rle0_decode, rle0_encode
from .rans import RansDecoder, RansEncoder


def _make_models():
    exp_model = AdaptiveModel(MAX_MODELS)
    mant = []
    for c in range(MAX_MODELS):
        alpha = int(EXPONENT[c + 1] - EXPONENT[c])
        if c < MODEL_SWITCH_THRESHOLD:
            mant.append(AdaptiveModel(alpha))
        else:
            mant.append(QuasiModel(alpha))
    return exp_model, mant


def write_chunk_header(freqs, olen: int, clen: int, rlen: int) -> bytes:
    out = bytearray()
    for f in freqs:
        out += encode_leb128(int(f))
    out += encode_leb128(olen)
    out += encode_leb128(clen)
    out += encode_leb128(rlen)
    return bytes(out)


def read_chunk_header(buf, pos: int):
    freqs = [0] * 256
    for i in range(256):
        freqs[i], pos = decode_leb128(buf, pos)
    olen, pos = decode_leb128(buf, pos)
    clen, pos = decode_leb128(buf, pos)
    rlen, pos = decode_leb128(buf, pos)
    if not (0 <= olen <= ANS_CHUNK_SIZE) or not (0 <= rlen <= ANS_CHUNK_SIZE):
        raise ValueError("misaligned or corrupt chunk header")
    return freqs, olen, clen, rlen, pos


def lane_rlen(rlen: int, lanes: int, lane: int) -> int:
    """Symbols owned by `lane` when rlen symbols are dealt round-robin."""
    return (rlen - lane + lanes - 1) // lanes


def ans_encode(data: np.ndarray, chunk_size: int = ANS_CHUNK_SIZE,
               lanes: int = 0) -> bytes:
    """Encode a whole stage buffer (any length) into the chunked stream.

    chunk_size <= 1 MB stays decodable by the reference decoder (it honors
    per-chunk olen from the header); smaller chunks buy parallel-decode
    granularity for a small ratio cost.

    lanes >= 2 selects the JTX wide-interleave chunk layout: the chunk's
    RLE0 symbols are dealt round-robin across `lanes` independent model+rANS
    chains that share one rank/freq header.  This is the device generalization
    of the reference's 4-state ILP interleave (rans_byte.hpp:27-39, P6 of
    the survey): chains decode in lockstep as one vectorized loop, so the
    intra-chunk parallel width becomes a stream parameter — at a far lower
    header cost than shrinking chunks.  Not reference-decodable.
    """
    data = np.asarray(data, dtype=np.uint8)
    chunk_size = min(max(int(chunk_size), 1), ANS_CHUNK_SIZE)
    out = bytearray()
    for base in range(0, data.size, chunk_size):
        chunk = data[base : base + chunk_size].copy()
        out += ans_encode_chunk(chunk, lanes)
    return bytes(out)


def encode_pairs(syms) -> bytes:
    """Model one symbol chain and encode it through 4 interleaved rANS
    states (ans.cpp:152-208): the per-chain payload codec shared by the
    reference layout (1 chain/chunk) and JTX lanes (L chains/chunk)."""
    exp_model, mant = _make_models()
    exp_model.reset()
    for m in mant:
        m.reset()

    syms = np.asarray(syms, dtype=np.uint16)
    rlen = int(syms.size)
    lows = np.empty(rlen * 2, dtype=np.int64)
    fqs = np.empty(rlen * 2, dtype=np.int64)
    sptr = 0
    for sym in syms.tolist():
        e = int(LOG[sym])
        m = int(MANTISSA[sym])
        lows[sptr] = exp_model.sym_to_low(e)
        fqs[sptr] = exp_model.sym_to_freq(e)
        exp_model.update(e)
        mm = mant[e]
        lows[sptr + 1] = mm.sym_to_low(m)
        fqs[sptr + 1] = mm.sym_to_freq(m)
        if fqs[sptr] <= 0 or fqs[sptr + 1] <= 0:
            # Safety invariant mirroring the reference's debug asserts
            # (ans.cpp:162-184).  With the unsigned rescale semantics
            # (model.cpp:183) quasi frequencies are always >= 1, so this
            # should be unreachable; it guards against model-state bugs.
            raise ValueError("model failure (CDF): chunk not encodable in ref-compat mode")
        mm.update(m)
        sptr += 2

    # Reverse pass through 4 interleaved states.
    enc = RansEncoder()
    R = [RANS_BYTE_L] * 4
    for i in range(sptr - 1, -1, -1):
        x = enc.put(R[3], int(lows[i]), int(fqs[i]), PROB_BITS)
        R = [x, R[0], R[1], R[2]]
    enc.flush(R[3])
    enc.flush(R[2])
    enc.flush(R[1])
    enc.flush(R[0])
    return enc.getvalue()


def ans_encode_chunk(chunk: np.ndarray, lanes: int = 0) -> bytes:
    olen = int(chunk.size)
    ranked, freqs = rank_encode(chunk)
    syms = rle0_encode(ranked)
    rlen = int(syms.size)

    if lanes >= 2:
        payloads = [encode_pairs(syms[l::lanes]) for l in range(lanes)]
        lane_table = b"".join(encode_leb128(len(p)) for p in payloads)
        payload = lane_table + b"".join(payloads)
    else:
        payload = encode_pairs(syms)
    return write_chunk_header(freqs, olen, len(payload), rlen) + payload


def ans_decode(buf, expect_size=None, lanes: int = 0) -> np.ndarray:
    """Decode a full chunked stream back to the stage buffer."""
    buf = memoryview(buf)
    pos = 0
    parts = []
    while pos < len(buf):
        freqs, olen, clen, rlen, pos = read_chunk_header(buf, pos)
        parts.append(ans_decode_chunk(buf, pos, freqs, olen, clen, rlen, lanes))
        pos += clen
    if parts:
        out = np.concatenate(parts)
    else:
        out = np.zeros(0, dtype=np.uint8)
    if expect_size is not None and out.size != expect_size:
        raise ValueError("decoded size mismatch")
    return out


def decode_pairs(buf, pos, rlen) -> np.ndarray:
    """Decode one 4-state model chain of rlen symbols (ans.cpp:30-111)."""
    exp_model, mant = _make_models()
    exp_model.reset()
    for m in mant:
        m.reset()

    dec = RansDecoder(buf, pos)
    R = [dec.init_state() for _ in range(4)]

    syms = np.empty(rlen, dtype=np.uint16)
    for i in range(rlen):
        x = R[0]
        rng = RansDecoder.get(x, PROB_BITS)
        e = exp_model.range_to_sym(rng)
        x = dec.advance(x, exp_model.sym_to_low(e), exp_model.sym_to_freq(e), PROB_BITS)
        exp_model.update(e)
        R = [R[1], R[2], R[3], x]

        x = R[0]
        mm = mant[e]
        rng = RansDecoder.get(x, PROB_BITS)
        m = mm.range_to_sym(rng)
        x = dec.advance(x, mm.sym_to_low(m), mm.sym_to_freq(m), PROB_BITS)
        mm.update(m)
        R = [R[1], R[2], R[3], x]

        syms[i] = int(EXPONENT[e]) + m

    if any(r != RANS_BYTE_L for r in R):
        raise ValueError("invalid rANS state")
    return syms


def read_lane_table(buf, pos: int, rlen: int, lanes: int):
    """Per-lane payload lengths prefixed to a JTX wide-interleave payload."""
    lane_clens = []
    for _ in range(lanes):
        c, pos = decode_leb128(buf, pos)
        lane_clens.append(c)
    return lane_clens, pos


def interleave_lanes(lane_syms, rlen: int, lanes: int) -> np.ndarray:
    syms = np.empty(rlen, dtype=np.uint16)
    for l in range(lanes):
        syms[l::lanes] = lane_syms[l]
    return syms


def ans_decode_chunk(buf, pos, freqs, olen, clen, rlen, lanes: int = 0) -> np.ndarray:
    if lanes >= 2:
        lane_clens, p = read_lane_table(buf, pos, rlen, lanes)
        if sum(lane_clens) != clen - (p - pos):
            raise ValueError("corrupt lane table")
        lane_syms = []
        for l in range(lanes):
            lane_syms.append(decode_pairs(buf, p, lane_rlen(rlen, lanes, l)))
            p += lane_clens[l]
        syms = interleave_lanes(lane_syms, rlen, lanes)
    else:
        syms = decode_pairs(buf, pos, rlen)

    ranked = rle0_decode(syms, olen)
    return rank_decode(ranked, freqs)
