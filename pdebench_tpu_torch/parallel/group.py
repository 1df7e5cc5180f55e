"""Ranks of a multi-device solve: the port's stand-in for the reference's
`jax.sharding.Mesh` with its `ppermute` and `psum`.

The reference distributes a solve over the devices of one process
(shard_map over a 1-D mesh axis). Here every rank is a process of its own
(SPMD, as DOLFINx runs under MPI: pdebench/oracle/common.py:52,352-365),
joined by `torch.distributed`:

  exchange_rows   the neighbour exchange of a stripe's boundary rows (the
                  reference's two ppermutes, pdebench_tpu/parallel/halo.py
                  :104-105), zeros past the first and the last rank
  allreduce_sum   the sum over ranks of a tensor (psum; the partial dot
                  products of a stripe-sharded Krylov solve)
  gather_rows     the ranks' stripes stacked in rank order on every rank

Backends: gloo for CPU tensors; NCCL where each rank has a card of its
own; gloo where ranks share a card (NCCL refuses two ranks on one device),
and then every row and scalar passes through pinned host buffers
(`staging`). `launch` runs a function of the port on n ranks, one process
each (the spawn method), and returns rank 0's result. A failed exchange
raises; nothing retries.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist

# a collective that waits longer than this raises (a rank that died
# without its process ending)
TIMEOUT_S = 600


def rank_device(device, rank: int, size: int) -> torch.device:
    """Rank `rank`'s device: the CPU, its own card where there are `size`
    of them, else the card `device` names (the ranks share it)."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if device.index is None and torch.cuda.device_count() >= size:
        return torch.device("cuda", rank)
    return torch.device("cuda", device.index or 0)


def backend_for(device, size: int) -> str:
    """NCCL where rank_device gives each of `size` ranks on `device` a
    card of its own, else gloo (NCCL refuses two ranks on one card)."""
    devs = {rank_device(device, rank, size) for rank in range(size)}
    return "nccl" if torch.device(device).type == "cuda" and len(devs) == size else "gloo"


class Group:
    """One rank's view of the ranks: its index, their number, its device
    and the backend that joins them (None: no process group, which only a
    single rank, or a check made before any collective, may do).

    `exchange_s` / `reduce_s` add up the host seconds spent in row
    exchanges and in reductions, each timed from the moment this rank's
    device work before it has finished."""

    def __init__(self, rank: int, size: int, device, backend: Optional[str] = None):
        self.rank, self.size = int(rank), int(size)
        self.device = torch.device(device)
        self.backend = backend
        # gloo reads host memory only: CUDA tensors go through pinned buffers
        self.staging = "pinned-host" if self.device.type == "cuda" and backend == "gloo" else None
        self.exchange_s = self.reduce_s = 0.0
        self._buffers = {}

    @classmethod
    def from_default(cls, device) -> "Group":
        """The ranks of the default process group, this one on `device`."""
        return cls(dist.get_rank(), dist.get_world_size(), device, dist.get_backend())

    def __repr__(self) -> str:
        return (f"Group(rank={self.rank}, size={self.size}, device={self.device}, "
                f"backend={self.backend}, staging={self.staging})")

    def describe(self) -> str:
        """'gloo', 'nccl' or 'gloo+pinned-host' (the route rows and scalars take)."""
        return (self.backend or "none") + (f"+{self.staging}" if self.staging else "")

    # -- collectives ------------------------------------------------------

    def _settle(self) -> float:
        """Wait for this rank's queued device work, then start a timer."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return time.perf_counter()

    def _buffer(self, role: str, like: torch.Tensor) -> torch.Tensor:
        key = (role, tuple(like.shape), like.dtype)
        buf = self._buffers.get(key)
        if buf is None:
            buf = self._buffers[key] = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
        return buf

    def _stage(self, role: str, x: torch.Tensor) -> torch.Tensor:
        """x copied into pinned host buffer `role`, asynchronously: the
        next _settle waits for the copy."""
        return self._buffer(role, x).copy_(x, non_blocking=True)

    def exchange_rows(self, top: torch.Tensor, bottom: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Send `top` (this rank's first rows) to the previous rank and
        `bottom` (its last rows) to the next; return (above, below): the
        previous rank's last rows and the next rank's first rows, zeros
        where there is no such rank."""
        above, below = torch.zeros_like(bottom), torch.zeros_like(top)
        if self.size == 1:
            return above, below
        pairs = []  # (what this rank sends, where what it receives goes, peer)
        if self.rank > 0:
            pairs.append((top, above, self.rank - 1))
        if self.rank < self.size - 1:
            pairs.append((bottom, below, self.rank + 1))
        ops, landings = [], []
        for k, (send, land, peer) in enumerate(pairs):
            if self.staging:
                send, recv = self._stage(f"send{k}", send), self._buffer(f"recv{k}", land)
                landings.append((land, recv))
            else:
                send, recv = send.contiguous(), land
            ops += [dist.P2POp(dist.isend, send, peer), dist.P2POp(dist.irecv, recv, peer)]
        # one wait: the staging copies, and the copies out of the receive
        # buffers of the exchange before, are done
        t0 = self._settle()
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        for land, recv in landings:
            land.copy_(recv, non_blocking=True)
        self.exchange_s += time.perf_counter() - t0
        return above, below

    def allreduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of a tensor of any shape, the same on every
        rank: on x's device, or on the host where the sum was staged
        through it (the caller places it; a Krylov loop's dot products
        stay there, numbers that CUDA ops take with no copy back)."""
        if self.size == 1:
            return x
        flat = x.detach().reshape(-1)
        wire = self._stage("reduce", flat) if self.staging else flat.clone()
        t0 = self._settle()
        dist.all_reduce(wire)
        self.reduce_s += time.perf_counter() - t0
        return (wire.clone() if self.staging else wire).reshape(x.shape)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's `x` (all of one shape) concatenated along the first
        axis in rank order, on every rank."""
        if self.size == 1:
            return x
        wire = x.detach().contiguous()
        if self.staging:
            wire = wire.cpu()
        parts = [torch.empty_like(wire) for _ in range(self.size)]
        dist.all_gather(parts, wire)
        return torch.cat(parts).to(x.device)

    def gather_objects(self, obj) -> list:
        """Every rank's picklable `obj`, in rank order, on every rank."""
        if self.size == 1:
            return [obj]
        out = [None] * self.size
        dist.all_gather_object(out, obj)
        return out


# -- running a function on n ranks -----------------------------------------


def _rank_main(rank: int, size: int, device: str, workdir: str, fn: Callable, args: tuple) -> None:
    """One rank's process: join the group through a file in `workdir`, run
    fn(group, *args), rank 0 writes the result there."""
    torch.set_num_threads(1)
    dev = rank_device(device, rank, size)
    backend = backend_for(device, size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(workdir, "rendezvous"), rank=rank,
        world_size=size, timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    try:
        out = fn(Group.from_default(dev), *args)
        if rank == 0:
            part = os.path.join(workdir, "result.part")
            with open(part, "wb") as f:
                pickle.dump(out, f)
            os.replace(part, os.path.join(workdir, "result.pkl"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, size: int, device="cuda", *args) -> Any:
    """fn(group, *args) on `size` ranks, one spawned process each, joined
    by torch.distributed; returns rank 0's result (picklable). `fn` is a
    module-level function (it is sent by its import path). A single rank
    runs in this process, with no process group. An exception in a rank
    ends the others and raises here."""
    if size < 1:
        raise ValueError(f"need at least one rank, got {size}")
    if size == 1:
        return fn(Group(0, 1, rank_device(device, 0, 1)), *args)
    workdir = tempfile.mkdtemp(prefix="pdebench_ranks_")
    try:
        torch.multiprocessing.start_processes(
            _rank_main, args=(size, str(device), workdir, fn, args), nprocs=size,
            join=True, start_method="spawn",
        )
        with open(os.path.join(workdir, "result.pkl"), "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
