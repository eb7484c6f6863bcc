"""Scalar bit/digit codecs (reference: ``reference/src/scalar_utils.rs``).

Little-endian bit arrays (:class:`ScalarBits`, ``scalar_utils.rs:25-142``),
u64-array and hex codecs (``scalar_utils.rs:155-237``), and the base-4 digit
representation used by the width-4 SMT (``scalar_utils.rs:170-186``).
"""

from __future__ import annotations

from ..core.scalar import Scalar, NonReducedScalar


def get_bits(scalar: Scalar, process_bits: int) -> list[int]:
    """LSB-first bit array of the canonical encoding
    (``scalar_utils.rs:144-153``)."""
    v = scalar.v
    return [(v >> i) & 1 for i in range(process_bits)]


class ScalarBits:
    """LSB-first bit array of a (reduced) scalar with shift ops."""

    def __init__(self, bit_array: list[int]):
        self.bit_array = bit_array

    @staticmethod
    def from_scalar(scalar: Scalar, process_bits: int) -> "ScalarBits":
        return ScalarBits(get_bits(scalar.reduce(), process_bits))

    def to_scalar(self) -> Scalar:
        return self.to_non_reduced_scalar().reduce()

    def to_non_reduced_scalar(self) -> Scalar:
        v = 0
        for i, b in enumerate(self.bit_array):
            if b:
                v |= 1 << i
        return NonReducedScalar(v & ((1 << 255) - 1))

    def shl(self) -> None:
        """Shift left by one bit (towards MSB; LSB becomes 0)."""
        self.bit_array = [0] + self.bit_array[:-1]

    def shr(self) -> None:
        """Shift right by one bit (towards LSB; MSB becomes 0)."""
        self.bit_array = self.bit_array[1:] + [0]

    def new_left_shifted(self) -> "ScalarBits":
        return ScalarBits([0] + self.bit_array[:-1])

    def new_right_shifted(self) -> "ScalarBits":
        return ScalarBits(self.bit_array[1:] + [0])

    def is_msb_set(self) -> bool:
        return self.bit_array[-1] == 1

    def is_lsb_set(self) -> bool:
        return self.bit_array[0] == 1

    def __repr__(self) -> str:
        return repr(self.bit_array)


def scalar_to_u64_array(scalar: Scalar) -> list[int]:
    b = scalar.to_bytes()
    return [int.from_bytes(b[8 * i : 8 * i + 8], "little") for i in range(4)]


def u64_array_to_scalar(arr) -> Scalar:
    assert len(arr) == 4
    raw = b"".join(int(x).to_bytes(8, "little") for x in arr)
    return Scalar.from_bits(raw).reduce()


def get_base_4_repr(scalar: Scalar, limit_bytes: int) -> list[int]:
    """Big-endian base-4 digits of the low ``limit_bytes`` bytes
    (``scalar_utils.rs:170-186``: bits are reversed, then paired MSB-first)."""
    d = limit_bytes * 4
    n = limit_bytes * 8
    bits = get_bits(scalar, n)
    bits.reverse()
    base_4 = [0] * d
    for i in range(0, len(bits) - 1, 2):
        base_4[i // 2] = (bits[i] << 1) | bits[i + 1]
    return base_4


def decode_hex(s: str) -> bytes:
    if s[:2] in ("0x", "0X"):
        s = s[2:]
    if len(s) % 2 != 0:
        raise ValueError("input string has an odd number of bytes")
    return bytes.fromhex(s)


def get_scalar_from_hex(hex_str: str) -> Scalar:
    """Hex -> scalar, reproducing the reference's quirk exactly
    (``scalar_utils.rs:232-237``): the decoded (big-endian-looking) byte
    string is passed to ``from_bytes_mod_order`` which interprets it
    LITTLE-endian - so the loaded value is the byte-reversal of the hex
    number.  The Poseidon constants are loaded through this path
    (``gadget_poseidon.rs:65,85``), so parity requires keeping the quirk."""
    raw = decode_hex(hex_str)
    if len(raw) != 32:
        raise ValueError("expected 32 bytes")
    return Scalar.from_bytes_mod_order(raw)
