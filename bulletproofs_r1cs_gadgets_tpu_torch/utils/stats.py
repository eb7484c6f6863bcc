"""First-class circuit statistics (SURVEY.md S5: the reference only exposes
``num_constraints`` / ``num_multipliers`` counters printed ad hoc, e.g.
``reference/src/gadget_vsmt_2.rs:345``)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class CircuitStats:
    multipliers: int
    constraints: int
    commitments: int
    phase1_multipliers: int

    @property
    def padded_multipliers(self) -> int:
        n = max(1, self.multipliers)
        if n & (n - 1):
            n = 1 << n.bit_length()
        return n

    def __str__(self) -> str:
        return (
            f"CircuitStats(mult={self.multipliers} "
            f"(padded {self.padded_multipliers}), "
            f"constraints={self.constraints}, commitments={self.commitments})"
        )
