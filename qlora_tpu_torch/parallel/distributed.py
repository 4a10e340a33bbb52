"""The process group of a tensor-parallel world on one host.

The JAX package runs one process over a ``("tp",)`` mesh; the port runs one
process a rank under ``torch.distributed``.  Each rank holds its own shard
and runs the same forward on its local heads and columns; the collectives
of :class:`TPMesh` are its only contact with the other ranks.

Nothing picks a backend or a device by itself: the caller names both.

* ``"nccl"``, rank r on ``cuda:r``, where the machine has a card a rank;
* ``"gloo"`` with every rank on ``cuda:0``, where several ranks share one
  card (NCCL refuses two ranks on one device);
* ``"gloo"`` on the CPU.

gloo takes CUDA tensors for every collective used here (all-reduce and
all-gather; PyTorch 2.11 on an H100) and stages them through
host memory itself: the kernels stay on the card, the collective's bytes
cross the host.

Rendezvous goes through a ``FileStore`` in a directory the caller names,
never a TCP port, so that several worlds on one host cannot collide.
:func:`run_ranks` starts a world's processes and gathers what each returns.

Training runs over a mesh of named axes ``("dp", "fsdp", "tp")`` in the
JAX package's device order (``reshape(dp, fsdp, tp)``, row-major: rank =
(d·F + f)·T + t).  :func:`make_parallel_mesh` gives each axis, and the
joint data axes ``("dp", "fsdp")``, a process group of its own, each seen
by the rank as a :class:`TPMesh` (its rank on the axis, the axis' size,
``all_reduce``, ``all_gather``), so that the conjugate operators run on
any axis unchanged.  The multi-host ``initialize`` of the JAX package waits
for the second half of ROADMAP A7b.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass
class TPMesh:
    """One rank's view of a tensor-parallel world: its rank, the world's
    size, the process group, the rank's device and the backend;
    ``disagreements`` counts the calls of :meth:`same` in which some rank's
    tensor differed from rank 0's."""
    rank: int
    size: int
    group: object
    device: torch.device
    backend: str
    disagreements: int = 0
    collectives: int = 0

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's `x` (same shape and dtype on each); every
        rank gets the same bits.  A world of one returns a copy of `x` and
        makes none."""
        t = x.clone()
        if self.size > 1:
            self.collectives += 1
            dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's `x` concatenated along `dim` in rank order."""
        t = x.contiguous()
        if self.size == 1:
            return t
        self.collectives += 1
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=dim)

    def same(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's `x` on every rank, where each rank computed its own `x`
        (tokens, acceptance counts) from the same logits with the same
        seeded generator: every rank's is gathered and compared, a
        difference counted in ``disagreements``, and rank 0's used, so that
        the ranks' host state stays in step whatever happens."""
        parts = self.all_gather(x.contiguous()[None], dim=0)
        self.disagreements += int((parts != parts[:1]).any())
        return parts[0]

    def barrier(self) -> None:
        dist.barrier(group=self.group)


def init_process_group(size: int, rank: int, *, backend: str, device, store_dir: str,
                       timeout_s: float = 600.0) -> TPMesh:
    """Join rank `rank` of a world of `size` through a ``FileStore`` in
    `store_dir` (one directory a world), on `backend` ("nccl" or "gloo"),
    the rank running on `device`."""
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: one of {BACKENDS}")
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device a rank")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    store = dist.FileStore(os.path.join(store_dir, "store"), size)
    # NCCL binds its communicators to the rank's card up front when it is
    # named (without it, the first collective guesses the device)
    extra = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=timeout_s), **extra)
    return TPMesh(rank=rank, size=size, group=dist.group.WORLD, device=device,
                  backend=backend)


def mesh_coords(rank: int, dp: int, fsdp: int, tp: int) -> tuple:
    """(d, f, t) of world rank `rank` on a ``reshape(dp, fsdp, tp)`` mesh."""
    if not 0 <= rank < dp * fsdp * tp:
        raise ValueError(f"rank {rank} outside a mesh of {dp} x {fsdp} x {tp}")
    return rank // (fsdp * tp), (rank // tp) % fsdp, rank % tp


@dataclasses.dataclass
class ParallelMesh:
    """One rank's view of a ``(dp, fsdp, tp)`` world: its world rank, the
    axes' sizes, and a :class:`TPMesh` for each axis (``dp``, ``fsdp``,
    ``tp``), for the joint data axes (``data``: rank d·F + f of dp·F) and
    for the whole world (``world``)."""
    rank: int
    shape: dict
    world: TPMesh
    dp: TPMesh
    fsdp: TPMesh
    tp: TPMesh
    data: TPMesh

    @property
    def device(self) -> torch.device:
        return self.world.device

    @property
    def backend(self) -> str:
        return self.world.backend

    def axis(self, name: str) -> TPMesh:
        return getattr(self, name)

    def collectives(self) -> dict:
        """The collectives made so far, by axis (a world of one makes none)."""
        return {a: self.axis(a).collectives for a in ("dp", "fsdp", "tp", "data", "world")}


def _axis_groups(dp: int, fsdp: int, tp: int) -> dict:
    """Every group of world ranks along each axis, in a fixed order."""
    grid = [[[(d * fsdp + f) * tp + t for t in range(tp)] for f in range(fsdp)]
            for d in range(dp)]
    return {
        "dp": [[grid[d][f][t] for d in range(dp)] for f in range(fsdp) for t in range(tp)],
        "fsdp": [[grid[d][f][t] for f in range(fsdp)] for d in range(dp) for t in range(tp)],
        "tp": [grid[d][f] for d in range(dp) for f in range(fsdp)],
        "data": [[grid[d][f][t] for d in range(dp) for f in range(fsdp)] for t in range(tp)],
    }


def make_parallel_mesh(world: TPMesh, dp: int = 1, fsdp: int = 1, tp: int = 1) -> ParallelMesh:
    """The ``(dp, fsdp, tp)`` mesh over an initialized world of dp·fsdp·tp
    ranks.  Every rank creates every group (``dist.new_group`` is collective
    over the world), in the same order; an axis of size 1 gets no group and
    its collectives are identities, an axis of the whole world uses the
    world's."""
    if dp * fsdp * tp != world.size:
        raise ValueError(f"a mesh of {dp} x {fsdp} x {tp} needs {dp * fsdp * tp} ranks, "
                         f"the world has {world.size}")
    sizes = {"dp": dp, "fsdp": fsdp, "tp": tp, "data": dp * fsdp}
    views, made = {}, {}
    for name, groups in _axis_groups(dp, fsdp, tp).items():
        mine = None
        for ranks in groups:
            group = None
            if 1 < sizes[name] < world.size:
                # the data axes are dp's or fsdp's ranks when the other is 1:
                # one group serves both
                if tuple(ranks) not in made:
                    made[tuple(ranks)] = dist.new_group(ranks)
                group = made[tuple(ranks)]
            if world.rank in ranks:
                mine = (ranks.index(world.rank), group)
        r, group = mine
        if sizes[name] == world.size:
            group = world.group
        views[name] = TPMesh(rank=r, size=sizes[name], group=group, device=world.device,
                             backend=world.backend)
    return ParallelMesh(rank=world.rank, shape={"dp": dp, "fsdp": fsdp, "tp": tp},
                        world=world, **views)


def destroy_process_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(fn, rank, size, backend, devices, store_dir, args, queue):
    try:
        mesh = init_process_group(size, rank, backend=backend, device=devices[rank],
                                  store_dir=store_dir)
        try:
            out = fn(mesh, *args)
        finally:
            destroy_process_group()
        queue.put((rank, True, pickle.dumps(out)))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, size: int, *args, backend: str, devices, store_dir: str,
              per_rank: Optional[list] = None, timeout_s: Optional[float] = 1800.0) -> list:
    """Run ``fn(mesh, *args)`` in `size` new processes, rank r on
    ``devices[r]``, and return their results in rank order.

    `fn` must be importable by name (a module-level function) and its
    results picklable; `args` go to every rank.  With `per_rank` (a list of
    `size` tuples) rank r runs ``fn(mesh, *per_rank[r], *args)``: what only
    that rank receives (its shard, say) comes first.  A rank that raises ends
    the world: the others are stopped and the first traceback raised here.
    The processes are started with ``spawn``: a CUDA context does not
    survive ``fork``."""
    import queue as queue_mod

    import torch.multiprocessing as mp

    if len(devices) != size:
        raise ValueError(f"{len(devices)} devices for {size} ranks")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    if per_rank is not None and len(per_rank) != size:
        raise ValueError(f"{len(per_rank)} per-rank argument tuples for {size} ranks")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, size, backend, list(devices), store_dir,
                               (tuple(per_rank[r]) if per_rank else ()) + args, q),
                         daemon=True)
             for r in range(size)]
    for p in procs:
        p.start()
    results, error = {}, None
    deadline = None if timeout_s is None else datetime.datetime.now() + \
        datetime.timedelta(seconds=timeout_s)
    try:
        while len(results) < size and error is None:
            try:
                rank, ok, payload = q.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    error = f"rank {dead[0]} exited with code {procs[dead[0]].exitcode}"
                elif deadline is not None and datetime.datetime.now() > deadline:
                    error = f"the world did not finish within {timeout_s} s"
                continue
            if ok:
                results[rank] = pickle.loads(payload)
            else:
                error = f"rank {rank} raised:\n{payload}"
    finally:
        for p in procs:
            if error is not None and p.is_alive():
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if error is not None:
        raise RuntimeError(error)
    return [results[r] for r in range(size)]
