"""Process groups, metric reductions and the gather: the port of
``ilqg_mujoco_tpu/parallel/distributed.py``.

One process per card: each rank owns one device and solves its block of
the global batch (``parallel/batch.py``).  Problems are independent, so the
only traffic between ranks is a metric's mean and the final gather of the
batch.  ``nccl`` joins ranks on cards; ``gloo`` joins ranks on the CPU, and
is the one way two ranks can share a card (NCCL refuses that).

    from ilqg_mujoco_torch.parallel import distributed
    records = distributed.launch(fn, 4, cfg)          # 4 cards, nccl
    records = distributed.launch(fn, 2, cfg, device="cpu")       # gloo

``fn(mesh, *args)`` runs on every rank and must be importable from the
package: the ``spawn`` start method that CUDA needs imports it by name.
"""

from __future__ import annotations

import datetime
import os
import pathlib
import socket
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..kernels import _build
from ..physics.model import resolve_device
from .batch import Mesh, make_mesh, tree_map

# how long a rank waits for the others (joining, a collective) and how long
# ``launch`` waits for every rank to end, before the run fails
TIMEOUT_S = 600.0


def initialize(coordinator: str = None, num_processes: int = None,
               process_id: int = None, device=None, backend: str = None):
    """Join the process group of ``num_processes`` ranks (nothing for a
    single process).  A missing argument is read from ``ILQG_COORDINATOR``
    (``host:port``, default 127.0.0.1:12345), ``ILQG_NUM_PROCESSES``
    (default 1) or ``ILQG_PROCESS_ID`` (default 0), as in the JAX package.

    The rank's device is the card ``cuda:{local rank}`` (``LOCAL_RANK``,
    else the process id: on one host they are the same), made current,
    unless ``device`` names it.  The backend is ``nccl`` on a card and
    ``gloo`` on the CPU unless ``backend`` names it.  Asking for a card
    where there is none, ``nccl`` off a card, or more ``nccl`` ranks on a
    host than it has cards raises.  A rank that is missing fails the join
    after ``TIMEOUT_S``."""
    if num_processes is None:
        num_processes = int(os.environ.get("ILQG_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return
    if process_id is None:
        process_id = int(os.environ.get("ILQG_PROCESS_ID", "0"))
    coordinator = coordinator or os.environ.get("ILQG_COORDINATOR",
                                                "127.0.0.1:12345")
    if device is None:
        local = int(os.environ.get("LOCAL_RANK", process_id))
        resolve_device("cuda")
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"local rank {local} has no card: this host "
                               f"has {torch.cuda.device_count()}")
        device = f"cuda:{local}"
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"nccl joins ranks on cards, not on {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
        device_id=dev if backend == "nccl" else None)


def _on_gloo() -> bool:
    return dist.get_backend() == "gloo"


def global_mean(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Scalar mean of a per-instance metric over the whole batch, each rank
    passing its block: one ``all_reduce`` of the blocks' sums and counts.
    Returns a 0-dim float64 tensor on the rank's device."""
    part = torch.stack([x.sum().double(),
                        torch.tensor(float(x.numel()), dtype=torch.float64,
                                     device=x.device)])
    if mesh.world > 1:
        part = part.cpu() if _on_gloo() else part
        dist.all_reduce(part)
    return (part[0] / part[1]).to(mesh.device)


def gather_batch(tree, mesh: Mesh):
    """The whole batch on every rank, the blocks in rank order (the
    counterpart of ``multihost_utils.process_allgather(..., tiled=True)``):
    every tensor of ``tree`` is gathered along its leading dim, onto the
    rank's device.  Under ``gloo`` it gathers CPU copies."""
    if mesh.world == 1:
        return tree

    def gather(x):
        x = (x.cpu() if _on_gloo() else x).contiguous()
        parts = [torch.empty_like(x) for _ in range(mesh.world)]
        dist.all_gather(parts, x)
        return torch.cat(parts).to(mesh.device)
    return tree_map(gather, tree)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, nprocs, coordinator, device, backend, args, out):
    """One rank: join, run ``fn(mesh, *args)``, save its result."""
    initialize(coordinator, nprocs, rank, device, backend)
    try:
        result = fn(make_mesh(nprocs, device), *args)
        torch.save(result, pathlib.Path(out) / f"rank{rank}.pt")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn, nprocs: int, *args, device=None,
           timeout: float = TIMEOUT_S) -> list:
    """Run ``fn(mesh, *args)`` on ``nprocs`` ranks started with
    ``torch.multiprocessing.spawn`` on a free local port; returns each
    rank's result, in rank order.

    ``device=None`` gives rank r the card ``cuda:r`` over ``nccl``;
    ``"cpu"`` runs every rank on the CPU over ``gloo``; a named card
    (``"cuda:0"``) is shared by every rank, over ``gloo``.  The kernels are
    built here, before the ranks start.  Raises if a rank raises or exits
    early (the others are stopped), or if the ranks are not done after
    ``timeout`` seconds."""
    if nprocs < 1:
        raise ValueError(f"nprocs must be at least 1, got {nprocs}")
    dev = resolve_device(device)
    backend = None if device is None else "gloo"
    if dev.type == "cuda":
        if device is None and nprocs > torch.cuda.device_count():
            raise RuntimeError(f"{nprocs} ranks, one per card, on "
                               f"{torch.cuda.device_count()} card(s)")
        _build.build_all()
    with tempfile.TemporaryDirectory() as out:
        ctx = mp.spawn(_rank_main, nprocs=nprocs, join=False,
                       args=(fn, nprocs, f"127.0.0.1:{_free_port()}", device,
                             backend, args, out))
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=5.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{nprocs} ranks not done after "
                                       f"{timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10.0)
        return [torch.load(pathlib.Path(out) / f"rank{r}.pt",
                           weights_only=False) for r in range(nprocs)]
