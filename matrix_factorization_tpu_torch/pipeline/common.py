"""Shared pipeline plumbing: directory contract, schema guards and the
device switch (PyTorch port of ``matrix_factorization_tpu/pipeline/common.py``).

Reference: ``project_template/pipeline/common.py:7-34``.
"""

from __future__ import annotations

from pathlib import Path

from matrix_factorization_tpu_torch.core.config import Paths, require_columns  # noqa: F401
from matrix_factorization_tpu_torch.core.device import resolve_device


def default_paths(root: str | Path | None = None) -> Paths:
    """Paths rooted at the given dir (default: cwd /workdir)."""
    return Paths(Path(root) if root else Path.cwd() / "workdir").ensure()


def add_paths_arg(parser) -> None:
    parser.add_argument(
        "--root", type=str, default=None,
        help="pipeline root dir (creates data/ features/ artifacts/)",
    )
    parser.add_argument(
        "--platform", type=str, default=None, choices=["cpu", "cuda"],
        help="the torch device of the stage's tensors (default: cuda, "
        "which raises without a GPU)",
    )


def cli_setup(args) -> Paths:
    """Check that ``--platform``'s device exists (no GPU for the default
    raises ``RuntimeError``) and return the directory contract; the stage
    passes ``args.platform`` on as its ``device``."""
    resolve_device(getattr(args, "platform", None))
    return default_paths(args.root)
