"""Faults planted in what the timed path produces, for the control run
and the tests: each is a ``fault(kind, index, proof)`` hook that
``drive.run`` applies to every proof the window makes (None drops it)."""

from __future__ import annotations


def _proof(raw: bytes):
    from bulletproofs_r1cs_gadgets_tpu_torch import R1CSProof

    return R1CSProof.from_bytes(raw)


def tamper(_kind, _i, proof):
    """Every proof with one byte flipped (the IPP's `a` scalar): the
    guarantee that an altered proof is rejected."""
    raw = bytearray(proof.to_bytes())
    raw[len(raw) - 64] ^= 1
    return _proof(bytes(raw))


class Stale:
    """Each step hands out the proof of the step before: a step that
    returns its state unchanged."""

    def __init__(self):
        self.last = None

    def __call__(self, _kind, _i, proof):
        out = self.last if self.last is not None else proof
        self.last = proof
        return out


def drop_half(_kind, i, proof):
    """Every other proof lost: half of a group left out."""
    return None if i % 2 else proof

