"""Process groups for the mesh: join a world of ranks, or spawn one
(PyTorch).

Counterpart of :mod:`whvi_tpu.parallel.distributed`. A JAX program sees
every device of its slice from one process a host; here every rank is
its own process in a ``torch.distributed`` group, one a card (NCCL) or
several sharing a card or the CPU (gloo), and the mesh
(:mod:`whvi_tpu_torch.parallel.mesh`) lays the group's ranks out.

Typical launches::

    torchrun --nproc-per-node 4 -m whvi_tpu_torch.experiments.run_scaling --mesh 2x2

    from whvi_tpu_torch.parallel import init_distributed, make_mesh
    init_distributed()                 # torchrun's environment, or a world of one
    mesh = make_mesh(data=2, sample=2)

or, from one process, :func:`spawn` (the tests, ``run_scaling
--force-cpu-devices``, the chip smoke).

The backend is explicit. The default is NCCL where there is a card, and
NCCL takes one card a rank: more ranks than cards on one host raise, and
sharing a card needs ``backend="gloo"``, which is logged (gloo stages a
CUDA tensor's collective through the host). Every group gets a collective
timeout, so a rank that dies fails the run instead of hanging it.
"""

from __future__ import annotations

import logging
import os
import pickle
import shutil
import tempfile
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["TIMEOUT", "init_distributed", "is_distributed", "rank_device", "spawn"]

TIMEOUT = timedelta(seconds=300)  # a collective that waits longer fails

_log = logging.getLogger(__name__)


def _local_rank(rank: int) -> int:
    return int(os.environ.get("LOCAL_RANK", rank))


def _local_world(world_size: int) -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size))


def rank_device(device_kind: str, rank: int | None = None) -> torch.device:
    """The device of ``rank`` (this process's rank by default): the CPU, or
    card ``local_rank % cards``, so ranks beyond the card count share."""
    if device_kind == "cpu":
        return torch.device("cpu")
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", _local_rank(rank) % torch.cuda.device_count())


def _check_backend(backend: str, world_size: int, log: bool = False) -> None:
    """NCCL refuses two ranks on one card: say so before it hangs or
    fails deep inside; with ``log``, log ranks that share a card under
    gloo."""
    local = _local_world(world_size)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend == "nccl" and local > cards:
        raise ValueError(
            f"NCCL takes one card a rank: {local} ranks on this host, {cards} "
            "cards; pass backend='gloo' to share a card"
        )
    if log and backend == "gloo" and cards and local > cards:
        _log.warning("gloo: %d ranks share %d card(s)", local, cards)


def init_distributed(
    backend: str | None = None,
    init_method: str | None = None,
    rank: int | None = None,
    world_size: int | None = None,
    timeout: timedelta = TIMEOUT,
) -> None:
    """Join the process group (idempotent: a group already set up is kept).

    With explicit ``init_method``, ``rank`` and ``world_size``, those;
    else torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``/``MASTER_PORT``); else, with nothing to join, a world
    of one over an in-process store, which is logged. ``backend``: None
    for NCCL where there is a card and gloo on the CPU. Under NCCL the
    rank's card becomes the current device. A failure to join a launched
    group raises."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    store = None
    if init_method is None and rank is None and world_size is None:
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            init_method = "env://"
            rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        else:
            _log.warning("no launched group: a world of one on %s", backend)
            store, rank, world_size = dist.HashStore(), 0, 1
    elif rank is None or world_size is None:
        raise ValueError("init_method needs rank and world_size")
    _check_backend(backend, world_size, log=rank == 0)
    if backend == "nccl":
        torch.cuda.set_device(rank_device("cuda", rank))
    dist.init_process_group(
        backend, init_method=init_method, store=store, rank=rank,
        world_size=world_size, timeout=timeout,
    )


def is_distributed() -> bool:
    """Whether this process is one rank of a world of more than one (the
    JAX package's ``is_multi_host``: a rank here is a process, not a
    host)."""
    return dist.is_initialized() and dist.get_world_size() > 1


def _rank_main(rank, fn, world_size, backend, device_kind, store, args):
    torch.set_num_threads(1)
    init_distributed(backend, f"file://{store}", rank, world_size)
    try:
        out = fn(rank_device(device_kind), *args)
        with open(f"{store}.out{rank}", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, backend: str, device_kind: str, *args) -> list:
    """Run ``fn(device, *args)`` in ``world_size`` new processes (the
    ``spawn`` start method), each one rank of a ``backend`` group over a
    file store (collective timeout :data:`TIMEOUT`), on
    ``rank_device(device_kind)``; returns every rank's result, in rank
    order. ``fn`` must be importable by name (a
    module-level function) and its arguments and result picklable. A
    rank that raises ends the others and raises here."""
    if device_kind not in ("cpu", "cuda"):
        raise ValueError(f"device_kind must be 'cpu' or 'cuda', got {device_kind!r}")
    if device_kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("spawn(device_kind='cuda') needs a card")
    _check_backend(backend, world_size)
    tmp = tempfile.mkdtemp(prefix="whvi_mesh_")
    store = os.path.join(tmp, "store")
    try:
        mp.start_processes(
            _rank_main,
            args=(fn, world_size, backend, device_kind, store, args),
            nprocs=world_size,
            join=True,
            start_method="spawn",
        )
        out = []
        for r in range(world_size):
            with open(f"{store}.out{r}", "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
