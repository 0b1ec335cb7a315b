"""What every part of the port's benchmark shares: the manifest and the
files it names, seeds, and the checks' record.

The benchmark is driven by data. ``BENCHMARK.json`` names each cell's
configuration and traffic mix; the harness finds them as
``portbench/configs/<config>.json`` and ``portbench/traffic/<mix>.json``.
A mix names its ``driver``, the module ``portbench/drivers/<driver>.py``
that drives one entry point of the program, and each per-layer metric is
read by ``portbench/metrics/<metric>.py``. A cell, a configuration, a mix
or a metric is added by adding files and entries, never by editing one.
"""

from __future__ import annotations

import importlib.util
import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"

# top-level module names that may not be loaded in a run: JAX, its
# companions and the JAX package the port was made from (compared whole,
# so ``matrix_factorization_tpu_torch`` is not among them)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "matrix_factorization_tpu")


def load_manifest(path: Path = MANIFEST) -> dict:
    return json.loads(Path(path).read_text())


def config_path(name: str) -> Path:
    return BENCH_DIR / "configs" / f"{name}.json"


def mix_path(name: str) -> Path:
    return BENCH_DIR / "traffic" / f"{name}.json"


def driver_path(name: str) -> Path:
    return BENCH_DIR / "drivers" / f"{name}.py"


def metric_path(name: str) -> Path:
    return BENCH_DIR / "metrics" / f"{name}.py"


def load_module(path: Path, name: str) -> ModuleType:
    """Import a file of the benchmark by its path (metric files carry dots
    in their names, which the import statement cannot spell)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} does not exist")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def end_to_end_for(manifest: dict, cell: str) -> List[dict]:
    """The end-to-end metrics a cell reports: those without a
    ``workloads`` list, and those whose list names the cell."""
    return [m for m in manifest["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def per_layer_for(manifest: dict, cell: str) -> List[dict]:
    """The per-layer metrics read in a cell's traced run: those whose
    ``workloads`` name it."""
    return [m for m in manifest["per_layer"] if cell in m["workloads"]]


def sub_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for ``torch.Generator.manual_seed`` (or numpy) from
    the run's seed and a stream number, mixed by numpy's SeedSequence so
    that neighbouring seeds share no stream. Any integers."""
    ss = np.random.SeedSequence([int(x) % (1 << 64) for x in (seed, *stream)])
    return int(ss.generate_state(1, np.uint64)[0] & ((1 << 63) - 1))


@dataclass
class Cell:
    """One run of one cell: its manifest entry, configuration, mix, seed
    and device."""

    name: str
    config: dict
    mix: dict
    seed: int
    device: str = "cuda"

    @classmethod
    def load(cls, manifest: dict, name: str, seed: int,
             device: str = "cuda") -> "Cell":
        w = workload(manifest, name)
        return cls(name=name,
                   config=json.loads(config_path(w["config"]).read_text()),
                   mix=json.loads(mix_path(w["traffic"]).read_text()),
                   seed=seed, device=device)


@dataclass
class Checks:
    """The numbers a run compares, each beside its limit. A number that
    is not finite, or that passes its limit, makes the run not correct;
    so does a named failure (an answer that never came)."""

    rows: Dict[str, dict] = field(default_factory=dict)
    failures: List[str] = field(default_factory=list)

    def add(self, name: str, value: float, limit: float) -> None:
        self.rows[name] = {"value": float(value), "limit": float(limit)}

    def fail(self, why: str) -> None:
        self.failures.append(why)

    @property
    def correct(self) -> bool:
        return not self.failures and bool(self.rows) and all(
            math.isfinite(r["value"]) and r["value"] <= r["limit"]
            for r in self.rows.values())

    def lines(self) -> List[str]:
        out = [f"check {n}: {r['value']!r} (limit {r['limit']!r})"
               for n, r in self.rows.items()]
        out += [f"check failed: {f}" for f in self.failures]
        return out
