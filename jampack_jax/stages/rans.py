"""Byte-renormalizing 32-bit rANS primitives.

L = 2^23 normalization lower bound; the encoder works in reverse and emits
bytes backwards, the decoder runs forward.  Multiple states interleave into
one bytestream with no extra signaling, which is what the 4-way (reference)
and N-way (native device) stream layouts exploit.

Reference behavior: rans_byte.hpp:50-154.
"""

from ..format.constants import RANS_BYTE_L

_M32 = 0xFFFFFFFF


class RansEncoder:
    """Encodes into an in-memory byte stack (bytes come out reversed)."""

    __slots__ = ("out",)

    def __init__(self):
        self.out = bytearray()  # appended; logically grows backwards

    def put(self, state: int, start: int, freq: int, scale_bits: int) -> int:
        assert freq > 0
        x = state
        x_max = ((RANS_BYTE_L >> scale_bits) << 8) * freq
        while x >= x_max:
            self.out.append(x & 0xFF)
            x >>= 8
        return (((x // freq) << scale_bits) + (x % freq) + start) & _M32

    def flush(self, state: int):
        # 4-byte little-endian, written backwards (we append reversed)
        for shift in (24, 16, 8, 0):
            self.out.append((state >> shift) & 0xFF)

    def getvalue(self) -> bytes:
        """The forward-order encoded stream."""
        return bytes(reversed(self.out))


class RansDecoder:
    __slots__ = ("buf", "pos")

    def __init__(self, buf, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def init_state(self) -> int:
        b = self.buf
        p = self.pos
        x = b[p] | (b[p + 1] << 8) | (b[p + 2] << 16) | (b[p + 3] << 24)
        self.pos = p + 4
        return x

    @staticmethod
    def get(state: int, scale_bits: int) -> int:
        return state & ((1 << scale_bits) - 1)

    def advance(self, state: int, start: int, freq: int, scale_bits: int) -> int:
        mask = (1 << scale_bits) - 1
        x = (freq * (state >> scale_bits) + (state & mask) - start) & _M32
        while x < RANS_BYTE_L:
            x = ((x << 8) | self.buf[self.pos]) & _M32
            self.pos += 1
        return x
