"""R1CS proof object and byte codec (dalek-layout).

Serialization follows the dalek bulletproofs ``R1CSProof`` wire format the
reference's engine produces: a 1-byte phase tag (0 = one-phase, omitting the
second-phase commitments; 1 = two-phase), eleven-or-eight 32-byte compressed
points, three 32-byte scalars, then the inner-product proof (interleaved
L/R pairs followed by a, b).
"""

from __future__ import annotations

from .ipp import InnerProductProof, _canonical_scalar
from .errors import FormatError
from .scalar import Scalar

ONE_PHASE_COMMITMENTS = 0
TWO_PHASE_COMMITMENTS = 1

_IDENTITY = b"\x00" * 32


class R1CSProof:
    __slots__ = (
        "A_I1", "A_O1", "S1", "A_I2", "A_O2", "S2",
        "T_1", "T_3", "T_4", "T_5", "T_6",
        "t_x", "t_x_blinding", "e_blinding", "ipp_proof",
    )

    def __init__(
        self,
        A_I1: bytes, A_O1: bytes, S1: bytes,
        A_I2: bytes, A_O2: bytes, S2: bytes,
        T_1: bytes, T_3: bytes, T_4: bytes, T_5: bytes, T_6: bytes,
        t_x: Scalar, t_x_blinding: Scalar, e_blinding: Scalar,
        ipp_proof: InnerProductProof,
    ):
        self.A_I1, self.A_O1, self.S1 = A_I1, A_O1, S1
        self.A_I2, self.A_O2, self.S2 = A_I2, A_O2, S2
        self.T_1, self.T_3, self.T_4, self.T_5, self.T_6 = T_1, T_3, T_4, T_5, T_6
        self.t_x = t_x
        self.t_x_blinding = t_x_blinding
        self.e_blinding = e_blinding
        self.ipp_proof = ipp_proof

    def _missing_phase2_commitments(self) -> bool:
        return (
            self.A_I2 == _IDENTITY and self.A_O2 == _IDENTITY and self.S2 == _IDENTITY
        )

    def to_bytes(self) -> bytes:
        out = bytearray()
        if self._missing_phase2_commitments():
            out.append(ONE_PHASE_COMMITMENTS)
            points = [self.A_I1, self.A_O1, self.S1]
        else:
            out.append(TWO_PHASE_COMMITMENTS)
            points = [self.A_I1, self.A_O1, self.S1, self.A_I2, self.A_O2, self.S2]
        points += [self.T_1, self.T_3, self.T_4, self.T_5, self.T_6]
        for pt in points:
            out += pt
        out += self.t_x.to_bytes()
        out += self.t_x_blinding.to_bytes()
        out += self.e_blinding.to_bytes()
        out += self.ipp_proof.to_bytes()
        return bytes(out)

    @staticmethod
    def from_bytes(data: bytes) -> "R1CSProof":
        if len(data) < 1 or (len(data) - 1) % 32 != 0:
            raise FormatError("bad proof length")
        version = data[0]
        body = data[1:]
        if version == ONE_PHASE_COMMITMENTS:
            min_points = 8
        elif version == TWO_PHASE_COMMITMENTS:
            min_points = 11
        else:
            raise FormatError(f"unknown proof version {version}")
        num_32 = len(body) // 32
        if num_32 < min_points + 3 + 2:
            raise FormatError("proof too short")
        chunks = [body[32 * i : 32 * (i + 1)] for i in range(num_32)]
        if version == ONE_PHASE_COMMITMENTS:
            A_I1, A_O1, S1 = chunks[0:3]
            A_I2 = A_O2 = S2 = _IDENTITY
            rest = 3
        else:
            A_I1, A_O1, S1, A_I2, A_O2, S2 = chunks[0:6]
            rest = 6
        T_1, T_3, T_4, T_5, T_6 = chunks[rest : rest + 5]
        t_x = _canonical_scalar(chunks[rest + 5])
        t_x_blinding = _canonical_scalar(chunks[rest + 6])
        e_blinding = _canonical_scalar(chunks[rest + 7])
        ipp = InnerProductProof.from_bytes(body[32 * (rest + 8) :])
        return R1CSProof(
            A_I1, A_O1, S1, A_I2, A_O2, S2,
            T_1, T_3, T_4, T_5, T_6,
            t_x, t_x_blinding, e_blinding, ipp,
        )

    def serialized_size(self) -> int:
        return len(self.to_bytes())

    def __eq__(self, other) -> bool:
        return isinstance(other, R1CSProof) and self.to_bytes() == other.to_bytes()
