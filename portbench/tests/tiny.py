"""The benchmark's cells cut to sizes the CPU holds in a test.

A configuration or a mix is cut by the sizes of ``CUT`` and ``CUT_MIX``
that it has (nested groups key by key), then a configuration by its own
entry in ``TINY`` where it has one; a configuration or a mix added later
runs at the generic cut without an entry."""

from __future__ import annotations

# the generic cut: each size a configuration or mix holds, at most this
CUT = {"n_users": 300, "n_items": 200, "n_ratings": 20_000, "n_factors": 8,
       "dim": 32, "generator": {"max_per_user": 150, "key_block": 1 << 16}}
CUT_MIX = {"batch_size": 4_096, "epochs_per_job": 2, "pool_calls": 16,
           "check_calls": 4, "trace_units": 3, "k": 10, "batch": 8}
# configurations' sizes set by name, after the generic cut
TINY = {"recipenlg-dense-512": {"n_items": 5_000}}


def _cut(target: dict, sizes: dict, cap: bool) -> None:
    for key, val in sizes.items():
        if key not in target:
            continue
        if isinstance(val, dict):
            _cut(target[key], val, cap)
        else:
            target[key] = min(target[key], val) if cap else val


def tiny_cell(manifest, name: str, seed: int = 123_456_789_012, device: str = "cpu"):
    """The manifest's cell ``name`` cut to a tiny size, with its own mix's
    limits."""
    from portbench.common import Cell, workload

    cell = Cell.load(manifest, name, seed, device)
    w = workload(manifest, name)
    _cut(cell.config, CUT, cap=True)
    _cut(cell.config, TINY.get(w["config"], {}), cap=False)
    _cut(cell.mix, CUT_MIX, cap=True)
    return cell
