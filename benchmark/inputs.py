"""The inputs of a run, drawn from its seed: the tree's items and, for
each proof the traffic asks for, its leaf and the seeds of its prover's
randomness and of its commitments' blindings.  Every seed gives the same
sizes (tree updates, depth, circuit); only the values differ.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from .named import load

L = 2**252 + 27742317777372353535851937790883648493


@dataclass(frozen=True)
class Case:
    key: int
    value: int
    prover_seed: int
    blind_seed: int


class Inputs:
    def __init__(self, config: dict, seed: int):
        self.seed = seed
        arity = load("reference/circuits", config["circuit"]).ARITY
        space = min(arity ** config["depth"], L)
        if config["tree_updates"] > space:
            raise ValueError("more tree updates than leaves")
        rnd = random.Random(f"tree:{seed}")
        items: dict[int, int] = {}
        while len(items) < config["tree_updates"]:
            items[rnd.randrange(space)] = rnd.randrange(L)
        self.items = items
        self.keys = list(items)

    def case(self, i: int) -> Case:
        """The i-th proof's leaf and seeds (i may be negative: warm-up)."""
        rnd = random.Random(f"case:{self.seed}:{i}")
        key = self.keys[rnd.randrange(len(self.keys))]
        return Case(key, self.items[key], rnd.getrandbits(32),
                    rnd.getrandbits(32))

    def step_seed(self, i: int) -> int:
        """The prover randomness of a restored prover's i-th proof."""
        return random.Random(f"step:{self.seed}:{i}").getrandbits(32)

    def sample(self, tag: str, population: list, k: int) -> list:
        rnd = random.Random(f"{tag}:{self.seed}")
        return sorted(rnd.sample(population, min(k, len(population))))
