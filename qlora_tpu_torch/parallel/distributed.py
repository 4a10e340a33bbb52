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
The multi-host ``initialize`` and the data-parallel meshes of the JAX
package belong to the training half of the port (ROADMAP A7b).
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

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's `x` (same shape and dtype on each); every
        rank gets the same bits."""
        t = x.clone()
        dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's `x` concatenated along `dim` in rank order."""
        t = x.contiguous()
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
    dist.init_process_group(backend, store=store, rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return TPMesh(rank=rank, size=size, group=dist.group.WORLD, device=device,
                  backend=backend)


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
