"""Configuration dataclasses (SURVEY.md S5: the reference has no runtime
config system - these capture its hard-coded constants as first-class,
overridable config objects)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class PoseidonConfig:
    """Reference defaults: gadget_poseidon.rs:617-622, :425-426."""

    width: int = 6
    full_rounds_beginning: int = 4
    full_rounds_end: int = 4
    partial_rounds: int = 140
    padding_const: int = 101
    zero_const: int = 0


@dataclass(frozen=True)
class MiMCConfig:
    """Reference default: gadget_mimc.rs:15."""

    rounds: int = 322


@dataclass(frozen=True)
class TreeConfig:
    """Reference defaults: gadget_vsmt_2.rs:23, gadget_vsmt_4.rs:25-28."""

    vsmt2_depth: int = 253
    vsmt4_depth: int = 128
    osmt_depth: int = 128
    # rebuild extension: close the reference's index-bit soundness gap
    constrain_index_bits: bool = True


@dataclass(frozen=True)
class EngineConfig:
    """Proof-engine + device-backend knobs.

    The two thresholds are the measured host/device crossover points of
    the respective backends (PERF_NOTES.md): the XLA-composed oracle
    backend pays per-op dispatch so it needs larger vectors to win; the
    fixed-shape Pallas chunk layer amortises dispatch and wins earlier.
    """

    gens_capacity: int = 819200  # reference's largest (gadget_vsmt_2.rs:290)
    party_capacity: int = 1  # all 14 reference call sites use 1
    min_device_n: int = 512  # XLA oracle backend host/device crossover
    pallas_min_device_n: int = 64  # Pallas chunk-layer crossover
    use_pallas: bool = True


@dataclass(frozen=True)
class FrameworkConfig:
    poseidon: PoseidonConfig = field(default_factory=PoseidonConfig)
    mimc: MiMCConfig = field(default_factory=MiMCConfig)
    trees: TreeConfig = field(default_factory=TreeConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)


DEFAULT_CONFIG = FrameworkConfig()
