"""Configuration objects for features, model and training.

The port's own copy of `qpnet_tpu/config.py`: the same dataclasses, the same
named-network registry and the same `model.conf` JSON, so a config written by
either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from dataclasses import dataclass, field
from typing import List


@dataclass
class AcousticConfig:
    """Feature geometry keyed by sampling rate (upsampling factor =
    floor(shiftms * fs / 1000))."""

    fs: int = 22050
    feature_type: str = "world"
    shiftms: float = 5.0
    fftl: int = 1024
    mag: float = 0.5
    mcep_dim_start: int = 2
    f0_dim_idx: int = 1
    highpass_cutoff: int = 70
    minf0: float = 40.0
    maxf0: float = 800.0
    # fs-derived (filled in __post_init__)
    mcep_alpha: float = 0.0
    aux_dim: int = 0
    mcep_dim: int = 0
    mcep_dim_end: int = 0
    ap_dim_idx: int = 0

    _FS_TABLE = {
        16000: dict(mcep_alpha=0.410, aux_dim=28, mcep_dim=24,
                    mcep_dim_end=27, ap_dim_idx=-1),
        22050: dict(mcep_alpha=0.455, aux_dim=39, mcep_dim=34,
                    mcep_dim_end=37, ap_dim_idx=-2),
        24000: dict(mcep_alpha=0.466, aux_dim=45, mcep_dim=39,
                    mcep_dim_end=42, ap_dim_idx=-3),
    }

    def __post_init__(self):
        if self.aux_dim == 0:
            if int(self.fs) not in self._FS_TABLE:
                raise ValueError(f"fs={self.fs} is not supported")
            for k, v in self._FS_TABLE[int(self.fs)].items():
                setattr(self, k, v)

    @property
    def upsampling_factor(self) -> int:
        return math.floor(self.shiftms * float(self.fs) / 1000)


# Named network registry (the reference recipe's two networks).
_NETWORKS = {
    "default": dict(dilationF_depth=4, dilationF_repeat=3,
                    dilationA_depth=4, dilationA_repeat=1,
                    kernel_size=2, max_length=30000,
                    batch_length=20000, batch_size=1,
                    f0_threshold=0, decode_batch_size=20),
    "Rd10Rr3Ed4Er1": dict(dilationF_depth=10, dilationF_repeat=3,
                          dilationA_depth=4, dilationA_repeat=1,
                          kernel_size=2, max_length=22500,
                          batch_length=20000, batch_size=1,
                          f0_threshold=0, decode_batch_size=7),
}


@dataclass(frozen=True)
class ModelConfig:
    """QPNet architecture hyper-parameters (frozen and hashable)."""

    n_quantize: int = 256
    n_aux: int = 39
    n_resch: int = 512
    n_skipch: int = 256
    dilationF_depth: int = 4
    dilationF_repeat: int = 3
    dilationA_depth: int = 4
    dilationA_repeat: int = 1
    kernel_size: int = 2
    dense_factor: int = 8
    upsampling_factor: int = 110

    @classmethod
    def from_network_name(cls, name: str, **overrides) -> "ModelConfig":
        if name not in _NETWORKS:
            raise ValueError(f"unknown network {name!r}")
        spec = _NETWORKS[name]
        kw = {k: v for k, v in spec.items()
              if k in {f.name for f in dataclasses.fields(cls)}}
        kw.update(overrides)
        return cls(**kw)

    @property
    def dilationsF(self) -> List[int]:
        return [2 ** i for i in range(self.dilationF_depth)] * self.dilationF_repeat

    @property
    def dilationsA(self) -> List[int]:
        return [2 ** i for i in range(self.dilationA_depth)] * self.dilationA_repeat

    @property
    def receptive_causal(self) -> int:
        return self.kernel_size - 1

    @property
    def receptiveF(self) -> int:
        return (self.kernel_size - 1) * sum(self.dilationsF)

    @property
    def receptiveA(self) -> int:
        """Per-unit adaptive receptive field; multiply by ceil(max dilated
        factor) for the actual span."""
        return (self.kernel_size - 1) * sum(self.dilationsA)

    def receptive_field(self, max_dilated_factor: float) -> int:
        """Total receptive field for a given maximum pitch-dilation factor."""
        return int(self.receptiveF
                   + self.receptiveA * math.ceil(max_dilated_factor)
                   + self.receptive_causal)


@dataclass
class TrainConfig:
    """Training hyper-parameters (persisted in `model.conf`)."""

    lr: float = 1e-4
    weight_decay: float = 0.0
    iters: int = 200000
    checkpoint_interval: int = 10000
    update_iters: int = 3000
    update_interval: int = 100
    batch_length: int = 20000
    batch_size: int = 1
    max_length: int = 30000
    f0_threshold: float = 0.0
    seed: int = 1
    intervals: int = 100  # log interval
    dtype: str = "float32"
    fixed_engine: str = "auto"


@dataclass
class RunConfig:
    """Aggregate persisted to `model.conf` (JSON)."""

    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    feature_type: str = "world"
    feature_format: str = "h5"
    fs: int = 22050

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "RunConfig":
        with open(path) as f:
            d = json.load(f)
        return cls(model=ModelConfig(**d["model"]), train=TrainConfig(**d["train"]),
                   **{k: d[k] for k in ("feature_type", "feature_format", "fs") if k in d})
