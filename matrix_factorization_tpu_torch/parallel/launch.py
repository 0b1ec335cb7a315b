"""A ``torch.distributed`` world of processes on one host.

The port's stand-in for ``__graft_entry__._provision_virtual_mesh``: where
the JAX package asks XLA for virtual CPU devices, the port starts one
process a rank. ``spawn_world`` is for the tests, the chip check and
``parallel/dryrun.py``; a user's program on N GPUs runs under ``torchrun
--nproc-per-node N`` instead and calls ``init_process_group`` itself.
"""

from __future__ import annotations

import os
import pickle
import queue
import tempfile
import traceback
from contextlib import contextmanager
from typing import Any, Callable, Iterator, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from matrix_factorization_tpu_torch.core.device import resolve_device

# seconds a world may run before the call gives up on it
DEFAULT_TIMEOUT = 900.0


def world_device(device=None) -> str:
    """The device every rank of a world runs on: ``None`` is ``cuda:0``
    (``resolve_device`` raises without a GPU), else ``device`` itself."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return str(dev)


@contextmanager
def world_of_one() -> Iterator[None]:
    """A gloo world of this process alone, run as a rank of
    :func:`spawn_world` runs: at one torch intra-op thread (the count is
    restored after), through a ``FileStore`` in a temporary directory. For
    the mesh paths at one rank inside a process whose cores other work
    shares (threads that wait on each other at every small op crawl)."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with tempfile.TemporaryDirectory(prefix="mf_world_") as tmp:
            dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                    rank=0, world_size=1)
            try:
                yield
            finally:
                dist.destroy_process_group()
    finally:
        torch.set_num_threads(n_threads)


def _child(rank: int, world_size: int, backend: str, device: str,
           store_path: str, call_path: str, results) -> None:
    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)
        torch.set_num_threads(1)  # ranks share the host's cores
        if backend == "nccl":
            device = f"cuda:{rank}"  # NCCL takes one GPU a rank
        if device.startswith("cuda"):
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group(backend, init_method=f"file://{store_path}",
                                rank=rank, world_size=world_size)
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - the parent reports it
        results.put((rank, False, traceback.format_exc()))


def spawn_world(fn: Callable, world_size: int, backend: str = "gloo",
                device=None, args: Sequence[Any] = (),
                timeout: float = DEFAULT_TIMEOUT) -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` new processes
    (start method ``spawn``), each inside ``init_process_group(backend)``
    and on ``device`` (every rank on the same one: ``None``, the default,
    is ``cuda:0`` and raises without a GPU; ``'cpu'`` when asked for. One
    GPU is shared by gloo ranks; NCCL refuses two ranks on one GPU, so an
    NCCL world runs rank r on ``cuda:r`` and raises ``ValueError`` when the
    host has fewer GPUs than ranks). The group
    rendezvous through a ``FileStore`` in a temporary directory, so that
    worlds started side by side never race for a TCP port. ``fn`` and
    ``args`` must pickle (a module-level function); so must what ``fn``
    returns. They reach the ranks through a file beside the store: a start
    pipe holds 64 KB, and a larger payload would make each start wait for
    the rank before it to boot. Returns the ranks' results in rank order. A rank that raises
    or dies fails the call with a ``RuntimeError`` holding its traceback
    (or exit code); every process is ended before the call returns."""
    if world_size < 1:
        raise ValueError(f"world_size must be positive, got {world_size}")
    device = world_device(device)
    if backend == "nccl" and world_size > torch.cuda.device_count():
        raise ValueError(
            f"an NCCL world of {world_size} ranks needs {world_size} GPUs, "
            f"one a rank; have {torch.cuda.device_count()}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="mf_world_") as tmp:
        store = os.path.join(tmp, "store")
        call = os.path.join(tmp, "call.pkl")
        with open(call, "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        procs = [ctx.Process(target=_child, args=(
            rank, world_size, backend, device, store, call, results),
            daemon=True) for rank in range(world_size)]
        for p in procs:
            p.start()
        got, errors = {}, []
        try:
            deadline = timeout
            while len(got) + len(errors) < world_size:
                try:
                    rank, ok, out = results.get(timeout=1.0)
                except queue.Empty:
                    deadline -= 1.0
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in got]
                    if dead:
                        errors.extend(f"rank {r} exited with code {code}"
                                      for r, code in dead)
                        break
                    if deadline <= 0:
                        errors.append(f"the world did not finish in {timeout} s")
                        break
                    continue
                if ok:
                    got[rank] = out
                else:
                    errors.append(f"rank {rank} failed:\n{out}")
                    break
        finally:
            for p in procs:
                p.join(timeout=10 if not errors else 1)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    if errors:
        raise RuntimeError("spawn_world: " + "\n".join(errors))
    return [got[r] for r in range(world_size)]
