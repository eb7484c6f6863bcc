"""STROBE-128 protocol framework (the sponge under Merlin transcripts).

Re-implements exactly the subset of STROBE v1.0.2 that merlin (the Fiat-Shamir
transcript crate used by the reference's proof engine) relies on: ``meta_AD``,
``AD``, ``PRF`` and ``KEY`` operations over Keccak-f[1600] at 128-bit security
(rate R = 166).  Transcript bytes must match merlin bit-for-bit, otherwise
every Fiat-Shamir challenge (and hence every proof) diverges - see
SURVEY.md S2b N8.
"""

from __future__ import annotations

from .keccak import f1600_bytes

try:  # optional C++ fast path (built from native/transcript.cpp)
    from ..native import _native

    _HAVE_NATIVE = _native is not None and hasattr(_native, "keccak_f1600")
except Exception:  # pragma: no cover
    _native = None
    _HAVE_NATIVE = False

STROBE_R = 166  # rate in bytes for Keccak-f[1600] at 128-bit security

FLAG_I = 1
FLAG_A = 1 << 1
FLAG_C = 1 << 2
FLAG_T = 1 << 3
FLAG_M = 1 << 4
FLAG_K = 1 << 5


class Strobe128:
    __slots__ = ("state", "pos", "pos_begin", "cur_flags")

    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, STROBE_R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        self._permute(st)
        self.state = st
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    @staticmethod
    def _permute(state: bytearray) -> None:
        if _HAVE_NATIVE:
            _native.keccak_f1600(state)
        else:
            f1600_bytes(state)

    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[STROBE_R + 1] ^= 0x80
        self._permute(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] ^= byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _overwrite(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] = byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray(n)
        for i in range(n):
            out[i] = self.state[self.pos]
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if flags != self.cur_flags:
                raise ValueError(
                    f"continued op with changed flags: {flags} != {self.cur_flags}"
                )
            return
        if flags & FLAG_T:
            raise NotImplementedError("transport operations are not supported")
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        force_f = (flags & (FLAG_C | FLAG_K)) != 0
        if force_f and self.pos != 0:
            self._run_f()

    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_A | FLAG_C, more)
        self._overwrite(data)
