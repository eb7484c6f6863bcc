"""Merlin transcript (Fiat-Shamir) on STROBE-128.

Byte-compatible re-implementation of ``merlin::Transcript`` plus the
transcript extension trait the Bulletproofs engine layers on top
(``append_scalar`` / ``append_point`` / ``challenge_scalar`` / domain
separators).  The reference crate instantiates transcripts with per-protocol
labels, e.g. ``Transcript::new(b"Factors")`` (``reference/src/factors.rs:57``)
and ``b"VSMT"`` (``reference/src/gadget_vsmt_2.rs:293``).
"""

from __future__ import annotations

from .strobe import Strobe128

MERLIN_PROTOCOL_LABEL = b"Merlin v1.0"


class Transcript:
    """merlin::Transcript equivalent."""

    __slots__ = ("strobe",)

    def __init__(self, label: bytes):
        self.strobe = Strobe128(MERLIN_PROTOCOL_LABEL)
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes) -> None:
        data_len = len(message).to_bytes(4, "little")
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(data_len, True)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, x: int) -> None:
        self.append_message(label, int(x).to_bytes(8, "little"))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        data_len = n.to_bytes(4, "little")
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(data_len, True)
        return self.strobe.prf(n, False)

    # --- Bulletproofs TranscriptProtocol extension -------------------------
    # (mirrors the `TranscriptProtocol` trait in the dalek bulletproofs crate
    # that the reference's engine dependency provides; scalars/points are the
    # 32-byte canonical encodings.)

    def r1cs_domain_sep(self) -> None:
        self.append_message(b"dom-sep", b"r1cs v1")

    def r1cs_1phase_domain_sep(self) -> None:
        self.append_message(b"dom-sep", b"r1cs-1phase")

    def r1cs_2phase_domain_sep(self) -> None:
        self.append_message(b"dom-sep", b"r1cs-2phase")

    def innerproduct_domain_sep(self, n: int) -> None:
        self.append_message(b"dom-sep", b"ipp v1")
        self.append_u64(b"n", n)

    def append_scalar(self, label: bytes, scalar) -> None:
        self.append_message(label, scalar.to_bytes())

    def append_point(self, label: bytes, point_bytes: bytes) -> None:
        assert len(point_bytes) == 32
        self.append_message(label, point_bytes)

    def validate_and_append_point(self, label: bytes, point_bytes: bytes) -> None:
        if point_bytes == b"\x00" * 32:
            raise ValueError("point is the identity")
        self.append_message(label, point_bytes)

    def challenge_scalar(self, label: bytes):
        from .scalar import Scalar

        return Scalar.from_bytes_mod_order_wide(self.challenge_bytes(label, 64))
