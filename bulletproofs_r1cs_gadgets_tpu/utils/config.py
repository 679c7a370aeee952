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

    ``min_device_n`` is the host/device crossover of ``DeviceBackend``:
    smaller MSMs run on the host, where device dispatch would dominate.
    """

    gens_capacity: int = 819200  # reference's largest (gadget_vsmt_2.rs:290)
    party_capacity: int = 1  # all 14 reference call sites use 1
    min_device_n: int = 512  # DeviceBackend host/device crossover


@dataclass(frozen=True)
class FrameworkConfig:
    poseidon: PoseidonConfig = field(default_factory=PoseidonConfig)
    mimc: MiMCConfig = field(default_factory=MiMCConfig)
    trees: TreeConfig = field(default_factory=TreeConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)


DEFAULT_CONFIG = FrameworkConfig()
