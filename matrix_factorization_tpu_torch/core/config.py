"""Typed configuration of the kernel-MF model and the batch pipeline
(PyTorch port).

Counterpart of ``matrix_factorization_tpu/core/config.py``: the same
``SGDConfig`` fields and derived widths, so that a table written by the
JAX package has the width the port expects, and copies of the pipeline's
directory contract (``Paths``) and schema guard. ``MeshConfig`` comes with
slice 6 of the port (multi-device).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# Row widths are padded to LANE columns and table heights to SUBLANE rows:
# the layout the JAX package writes, which checkpoints carry across.
LANE = 128
SUBLANE = 8


@dataclass(frozen=True)
class SGDConfig:
    """Static configuration of a kernel-MF model."""

    kernel: str = "linear"  # linear | sigmoid | rbf
    n_factors: int = 100
    lr: float = 0.01
    reg: float = 1.0
    gamma: float = 0.01
    min_rating: float = 0.0
    max_rating: float = 5.0
    batch_size: int = 1024
    update_user_params: bool = True
    update_item_params: bool = True
    compute_epoch_rmse: bool = True
    # 'batch' | 'full' | 'none': the training shuffle (see the JAX package)
    shuffle: str = "batch"
    # 'auto' | 'none': tile-aggregated training updates (see the JAX package)
    aggregate: str = "auto"

    @property
    def padded_factors(self) -> int:
        """Extended row width: factors + bias + const column, lane-padded."""
        return max(LANE, _round_up(self.n_factors + 2, LANE))

    @property
    def a(self) -> float:
        """Rescale offset for sigmoid/rbf kernels (reference kernels.py:67)."""
        return self.min_rating

    @property
    def c(self) -> float:
        """Rescale range for sigmoid/rbf kernels (reference kernels.py:68)."""
        return self.max_rating - self.min_rating


@dataclass
class Paths:
    """Directory contract for the batch pipeline (reference common.py:7-28)."""

    root: Path
    data: Path = field(init=False)
    features: Path = field(init=False)
    artifacts: Path = field(init=False)

    def __post_init__(self):
        self.root = Path(self.root)
        self.data = self.root / "data"
        self.features = self.root / "features"
        self.artifacts = self.root / "artifacts"

    def ensure(self) -> "Paths":
        for p in (self.data, self.features, self.artifacts):
            p.mkdir(parents=True, exist_ok=True)
        return self


def require_columns(df, columns, name: str = "dataframe") -> None:
    """Schema guard used by every pipeline stage (reference common.py:31-34)."""
    missing = [c for c in columns if c not in df.columns]
    if missing:
        raise ValueError(f"{name} is missing required columns: {missing}")


def config_to_dict(cfg: Any) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def save_config(cfg: Any, path: os.PathLike) -> None:
    Path(path).write_text(json.dumps(config_to_dict(cfg), indent=2, default=str))


def load_json(path: os.PathLike) -> Dict[str, Any]:
    return json.loads(Path(path).read_text())
