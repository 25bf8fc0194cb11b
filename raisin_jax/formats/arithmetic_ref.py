"""Adaptive arithmetic coder — exact `.rsn` wire format (host oracle).

Format (reference compressor/arithmetic/arithmetic.go, bits.go):

- 16-bit shift-based renormalizing arithmetic coder; constants
  ``maxCode=0xFFFF``, quarters at 0x4000/0x8000/0xC000, ``maxFreq=16383``
  (arithmetic.go:35-42).
- Order-0 adaptive model over 257 symbols (bytes 0..255 plus EOF=256) held as
  a 258-entry cumulative array initialized ``cum[i] = i`` (arithmetic.go:176).
  After *each* coded symbol (encode and decode alike) every higher cumulative
  count is incremented by one; the model freezes once ``cum[257] >= 16383``
  — the freeze flag is set *after* the triggering update (arithmetic.go:184).
- Encoder appends EOF (symbol 256) and runs E1/E2/E3 renormalization with
  pending-bit tracking (arithmetic.go:115-163). There is NO final flush: any
  trailing pending bits and the final low/high state are simply dropped — the
  decoder compensates by appending bits ``[1, 0]`` to the stream tail
  (arithmetic.go:48) and by reading 0 once bits are exhausted (bits.go:12).
- Bitstream is packed MSB-first with a PREPENDED ``0…01`` pad (bits.go:48).
"""

from __future__ import annotations

import numpy as np

from raisin_jax.bitkit.packing import pack_prepad_sentinel, unpack_prepad_sentinel

MAX_CODE = 0xFFFF
ONE_FOURTH = 0x4000
ONE_HALF = 0x8000
THREE_FOURTHS = 0xC000
CODE_VALUE_BITS = 16
MAX_FREQ = 16383
EOF_SYMBOL = 256
NUM_CUM = 258  # cum[0..257]; symbol s spans [cum[s], cum[s+1])


class Model:
    """Order-0 adaptive model (reference arithmetic.go:171-219)."""

    __slots__ = ("cum", "frozen")

    def __init__(self) -> None:
        self.cum = np.arange(NUM_CUM, dtype=np.int64)
        self.frozen = False

    def _update(self, symbol: int) -> None:
        self.cum[symbol + 1 :] += 1
        if self.cum[257] >= MAX_FREQ:
            self.frozen = True

    def probability(self, symbol: int) -> tuple[int, int, int]:
        """(lower, upper, count) for a symbol; advances the model."""
        lower = int(self.cum[symbol])
        upper = int(self.cum[symbol + 1])
        count = int(self.cum[257])
        if not self.frozen:
            self._update(symbol)
        return lower, upper, count

    def count(self) -> int:
        return int(self.cum[257])

    def char_for(self, scaled_value: int) -> tuple[int, int, int, int]:
        """(symbol, lower, upper, count) for a scaled value; advances the model.

        First symbol s with ``scaled_value < cum[s+1]`` (arithmetic.go:206).
        ``cum`` is strictly increasing, so a binary search is exact.
        """
        s = int(np.searchsorted(self.cum[1:NUM_CUM], scaled_value, side="right"))
        lower = int(self.cum[s])
        upper = int(self.cum[s + 1])
        count = int(self.cum[257])
        if not self.frozen:
            self._update(s)
        return s, lower, upper, count


def encode_bits(data: bytes) -> np.ndarray:
    """Encode to the raw (unpadded) bit array. Reference arithmetic.go:115."""
    model = Model()
    low, high = 0, MAX_CODE
    pending = 0
    out = bytearray()  # one entry per bit, values 0/1

    symbols = list(data) + [EOF_SYMBOL]
    for s in symbols:
        difference = high - low + 1
        lower, upper, count = model.probability(s)
        high = low + (difference * upper) // count - 1
        low = low + (difference * lower) // count
        while True:
            if high < ONE_HALF:
                out.append(0)
                out.extend(b"\x01" * pending)
                pending = 0
            elif low >= ONE_HALF:
                out.append(1)
                out.extend(b"\x00" * pending)
                pending = 0
            elif low >= ONE_FOURTH and high < THREE_FOURTHS:
                pending += 1
                low -= ONE_FOURTH
                high -= ONE_FOURTH
            else:
                break
            high = ((high << 1) + 1) & MAX_CODE
            low = (low << 1) & MAX_CODE
    # NB: no final flush — trailing pending bits are dropped (format quirk).
    return np.frombuffer(bytes(out), dtype=np.uint8)


def compress(data: bytes) -> bytes:
    """Byte-exact parity with reference arithmetic.Compress (arithmetic.go:15)."""
    return pack_prepad_sentinel(encode_bits(data))


def decode_bits(bits: np.ndarray) -> bytes:
    """Decode an unpadded bit array. Reference arithmetic.go:44."""
    model = Model()
    # Decoder tail: append [1, 0]; exhausted reads yield 0 (bits.go:12).
    bits = np.concatenate([np.asarray(bits, dtype=np.uint8), np.array([1, 0], dtype=np.uint8)])
    nbits = bits.size

    value = 0
    for i in range(CODE_VALUE_BITS):
        value = (value << 1) | (int(bits[i]) if i < nbits else 0)
    pos = min(CODE_VALUE_BITS, nbits)

    low, high = 0, MAX_CODE
    out = bytearray()
    # A valid stream reaches EOF within a bounded number of renorm shifts
    # after the bit supply (incl. the [1,0] tail) runs dry — each symbol's
    # renorm loop consumes at most ~16 bits. Corrupt data would otherwise
    # zero-fill forever (the reference hangs here); we fail instead.
    exhausted_shifts = 0
    while True:
        difference = high - low + 1
        scaled = ((value - low + 1) * model.count() - 1) // difference
        s, lower, upper, count = model.char_for(scaled)
        if s == EOF_SYMBOL:
            break
        out.append(s)
        high = low + (difference * upper) // count - 1
        low = low + (difference * lower) // count
        while True:
            if high < ONE_HALF:
                pass
            elif low >= ONE_HALF:
                value -= ONE_HALF
                low -= ONE_HALF
                high -= ONE_HALF
            elif low >= ONE_FOURTH and high < THREE_FOURTHS:
                value -= ONE_FOURTH
                low -= ONE_FOURTH
                high -= ONE_FOURTH
            else:
                break
            low <<= 1
            high = (high << 1) + 1
            value <<= 1
            if pos < nbits:
                value += int(bits[pos])
                pos += 1
            else:
                exhausted_shifts += 1
                if exhausted_shifts > 16 * CODE_VALUE_BITS:
                    raise ValueError("arithmetic: stream ended without EOF symbol")
    return bytes(out)


def decompress(data: bytes) -> bytes:
    """Byte-exact parity with reference arithmetic.Decompress (arithmetic.go:27)."""
    return decode_bits(unpack_prepad_sentinel(data))
