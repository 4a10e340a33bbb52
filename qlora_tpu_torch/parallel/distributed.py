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
cross the host.  Its point-to-point sends are another matter: they abort
the process on a CUDA tensor, so :meth:`TPMesh.rotate` moves CUDA blocks
between ranks of one card itself (CUDA IPC, :class:`_SameCard`).

Rendezvous goes through a ``FileStore`` in a directory the caller names,
never a TCP port, so that several worlds on one host cannot collide.
:func:`run_ranks` starts a world's processes and gathers what each returns.

Training runs over a mesh of named axes ``("dp", "fsdp", "tp", "sp")`` in
the JAX package's device order (``reshape(dp, fsdp, tp, sp)``, row-major:
rank = ((d·F + f)·T + t)·SP + s; without weight sharding JAX's
``reshape(dp, sp)`` is the same order).  :func:`make_parallel_mesh` gives
each axis, the joint data axes ``("dp", "fsdp")`` and the sequence-parallel
step's joint axes ``("dp", "fsdp", "sp")`` a process group of their own,
each seen by the rank as a :class:`TPMesh` (its rank on the axis, the
axis' size, ``all_reduce``, ``all_gather``, ``rotate``), so that the
conjugate operators run on any axis unchanged and the ring attention
rotates over the sp axis.  The multi-host ``initialize`` of the JAX
package waits for ROADMAP A7b's item 3.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import pickle
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


class Rotation:
    """A :meth:`TPMesh.rotate` in flight: :meth:`wait` returns the tensors
    received, shaped and typed as those sent."""

    def __init__(self, works, send, recv, layout):
        self.works, self.send, self.recv, self.layout = works, send, recv, layout
        self.received = None

    def wait(self) -> list:
        if self.received is None:
            for w in self.works:
                w.wait()
            self.received = _unpack(self.recv, self.layout)
            self.send = self.recv = None
        return list(self.received)


def _exchange(group, to, frm, tag, out: torch.Tensor, into: torch.Tensor):
    """Send `out` to world rank `to` and receive `into` from `frm` (CPU
    tensors, gloo), and wait for both."""
    for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, out, to, group, tag),
                                     dist.P2POp(dist.irecv, into, frm, group, tag)]):
        w.wait()


class _SameCard:
    """Rotations over gloo between processes that share one card
    (``chip_smoke.py`` train-sp runs four ranks on one H100): each rank
    packs its blocks into a send buffer of its own on the card, which its
    successor has mapped (CUDA IPC, once a buffer); a one-word gloo message
    says the buffer is written, the successor copies it card to card, and a
    second says it has, after which the buffer may be written again.  One
    channel, and one buffer, a (shift, tag) pair."""

    def __init__(self, mesh: "TPMesh"):
        self.mesh, self.channels = mesh, {}

    @staticmethod
    def check(mesh: "TPMesh") -> "_SameCard":
        """Every rank of `mesh` on this rank's card (collective), else raise."""
        mine = str(torch.cuda.get_device_properties(mesh.device).uuid)
        cards = [None] * mesh.size
        dist.all_gather_object(cards, mine, group=mesh.group)
        if any(c != mine for c in cards):
            raise ValueError("a rotation of CUDA tensors over gloo needs every rank of the group "
                             "on one card (gloo sends no CUDA tensor); use NCCL, a card a rank")
        return _SameCard(mesh)

    def _channel(self, flat, to, frm, shift, tag) -> dict:
        """This (shift, tag)'s buffer and the predecessor's, mapped; a new
        pair when the size changes (every rank sees the same sizes)."""
        from torch.multiprocessing.reductions import reduce_tensor

        key = (shift, tag)
        ch = self.channels.get(key)
        if ch is not None and ch["buf"].numel() == flat.numel():
            return ch
        buf = torch.empty_like(flat)
        rebuild, args = reduce_tensor(buf)
        mine = torch.frombuffer(bytearray(pickle.dumps(args)), dtype=torch.uint8)
        n = torch.zeros(1, dtype=torch.int64)
        ch = {"buf": buf, "ready": 4 * tag + 2 * (shift < 0)}
        group = self.mesh.group
        _exchange(group, to, frm, ch["ready"], torch.tensor([mine.numel()]), n)
        theirs = torch.empty(int(n), dtype=torch.uint8)
        _exchange(group, to, frm, ch["ready"], mine, theirs)
        ch["peer"] = rebuild(*pickle.loads(theirs.numpy().tobytes()))
        self.channels[key] = ch
        return ch

    def rotate(self, flat, layout, to, frm, shift, tag) -> Rotation:
        ch = self._channel(flat, to, frm, shift, tag)
        ch["buf"].copy_(flat)
        torch.cuda.synchronize(flat.device)      # written before the successor reads it
        signals = (torch.ones(1), torch.empty(1))
        ready = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, signals[0], to, self.mesh.group, ch["ready"]),
            dist.P2POp(dist.irecv, signals[1], frm, self.mesh.group, ch["ready"])])
        return _SameCardRotation(self.mesh.group, ch, ready, signals, layout, to, frm)


class _SameCardRotation(Rotation):
    def __init__(self, group, ch, ready, signals, layout, to, frm):
        self.group, self.ch, self.ready, self.signals = group, ch, ready, signals
        self.layout, self.to, self.frm = layout, to, frm
        self.received = None

    def wait(self) -> list:
        if self.received is None:
            for w in self.ready:
                w.wait()
            got = self.ch["peer"].clone()
            torch.cuda.synchronize(got.device)   # read before the predecessor writes again
            _exchange(self.group, self.frm, self.to, self.ch["ready"] + 1, torch.ones(1),
                      torch.empty(1))
            self.received = _unpack(got, self.layout)
        return list(self.received)


class _Done(Rotation):
    """The rotation of a world of one: the tensors themselves."""

    def __init__(self, tensors):
        self.received = list(tensors)


_ALIGN = 16      # bytes: every tensor of a packed rotation starts on a multiple


def _pack(tensors) -> tuple:
    """Tensors → one uint8 buffer (each tensor's bytes padded to _ALIGN)
    and the layout that :func:`_unpack` reads it back with."""
    parts, layout = [], []
    for t in tensors:
        b = t.detach().contiguous().reshape(-1).view(torch.uint8)
        pad = -b.numel() % _ALIGN
        parts.append(b if not pad else torch.cat([b, b.new_zeros(pad)]))
        layout.append((tuple(t.shape), t.dtype, b.numel() + pad))
    return torch.cat(parts), layout


def _unpack(buf, layout) -> list:
    out, at = [], 0
    for shape, dtype, n in layout:
        out.append(buf[at:at + n].view(dtype)[:math.prod(shape)].reshape(shape))
        at += n
    return out


@dataclasses.dataclass
class TPMesh:
    """One rank's view of a tensor-parallel world: its rank, the world's
    size, the process group, the rank's device and the backend;
    ``disagreements`` counts the calls of :meth:`same` in which some rank's
    tensor differed from rank 0's; ``ranks`` are the group's world ranks in
    axis order (the peers of :meth:`rotate`)."""
    rank: int
    size: int
    group: object
    device: torch.device
    backend: str
    disagreements: int = 0
    collectives: int = 0
    ranks: tuple = ()
    card: object = dataclasses.field(default=None, repr=False, compare=False)

    def rotate(self, tensors, shift: int = 1, tag: int = 0) -> Rotation:
        """Start sending `tensors` to the rank `shift` places on around the
        ring ((r + shift) mod n) and receiving the same shapes from the rank
        `shift` places back; ``shift=-1`` is the inverse rotation.  One
        message a call (the tensors packed), counted in ``collectives``.
        Over NCCL, and over gloo on the CPU, the group's point-to-point
        sends carry the bytes.  gloo sends no CUDA tensor (the process
        aborts), so CUDA tensors over gloo go card to card when every rank
        of the group holds the same card (:class:`_SameCard`), and raise
        otherwise.  Every rank of the group calls it, in the same order,
        with tensors of the same shapes; `tag` keeps two rotations in flight
        apart."""
        if self.size == 1:
            return _Done([t.detach() for t in tensors])
        self.collectives += 1
        flat, layout = _pack(tensors)
        ranks = self.ranks or tuple(range(self.size))
        to, frm = ranks[(self.rank + shift) % self.size], ranks[(self.rank - shift) % self.size]
        if self.backend == "gloo" and flat.is_cuda:
            if self.card is None:
                self.card = _SameCard.check(self)
            return self.card.rotate(flat, layout, to, frm, shift, tag)
        recv = torch.empty_like(flat)
        works = dist.batch_isend_irecv([dist.P2POp(dist.isend, flat, to, self.group, tag),
                                        dist.P2POp(dist.irecv, recv, frm, self.group, tag)])
        return Rotation(works, flat, recv, layout)

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
                  backend=backend, ranks=tuple(range(size)))


def mesh_coords(rank: int, dp: int, fsdp: int, tp: int, sp: int = 1) -> tuple:
    """(d, f, t) of world rank `rank` on a ``reshape(dp, fsdp, tp, sp)``
    mesh; its sp coordinate is ``rank % sp``."""
    if not 0 <= rank < dp * fsdp * tp * sp:
        raise ValueError(f"rank {rank} outside a mesh of {dp} x {fsdp} x {tp} x {sp}")
    rank //= sp
    return rank // (fsdp * tp), (rank // tp) % fsdp, rank % tp


@dataclasses.dataclass
class ParallelMesh:
    """One rank's view of a ``(dp, fsdp, tp, sp)`` world: its world rank,
    the axes' sizes, and a :class:`TPMesh` for each axis (``dp``, ``fsdp``,
    ``tp``, ``sp``), for the joint data axes (``data``: rank d·F + f of
    dp·F), for the sequence-parallel step's joint axes (``data_sp``: rank
    (d·F + f)·SP + s of dp·F·SP) and for the whole world (``world``)."""
    rank: int
    shape: dict
    world: TPMesh
    dp: TPMesh
    fsdp: TPMesh
    tp: TPMesh
    data: TPMesh
    sp: TPMesh
    data_sp: TPMesh

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
        return {a: self.axis(a).collectives
                for a in ("dp", "fsdp", "tp", "sp", "data", "data_sp", "world")}


def _axis_groups(dp: int, fsdp: int, tp: int, sp: int = 1) -> dict:
    """Every group of world ranks along each axis, in a fixed order (with
    sp = 1 the groups, and their order, of a ``(dp, fsdp, tp)`` mesh)."""
    r = lambda d, f, t, s: ((d * fsdp + f) * tp + t) * sp + s
    D, F, T, S = range(dp), range(fsdp), range(tp), range(sp)
    return {
        "dp": [[r(d, f, t, s) for d in D] for f in F for t in T for s in S],
        "fsdp": [[r(d, f, t, s) for f in F] for d in D for t in T for s in S],
        "tp": [[r(d, f, t, s) for t in T] for d in D for f in F for s in S],
        "data": [[r(d, f, t, s) for d in D for f in F] for t in T for s in S],
        "sp": [[r(d, f, t, s) for s in S] for d in D for f in F for t in T],
        "data_sp": [[r(d, f, t, s) for d in D for f in F for s in S] for t in T],
    }


def make_parallel_mesh(world: TPMesh, dp: int = 1, fsdp: int = 1, tp: int = 1,
                       sp: int = 1) -> ParallelMesh:
    """The ``(dp, fsdp, tp, sp)`` mesh over an initialized world of
    dp·fsdp·tp·sp ranks.  Every rank creates every group (``dist.new_group``
    is collective over the world), in the same order; an axis of size 1 gets
    no group and its collectives are identities, an axis of the whole world
    uses the world's, and an axis whose ranks another axis already grouped
    (the data axes when the others are 1) shares that group."""
    if dp * fsdp * tp * sp != world.size:
        raise ValueError(f"a mesh of {dp} x {fsdp} x {tp} x {sp} needs {dp * fsdp * tp * sp} "
                         f"ranks, the world has {world.size}")
    sizes = {"dp": dp, "fsdp": fsdp, "tp": tp, "data": dp * fsdp, "sp": sp,
             "data_sp": dp * fsdp * sp}
    views, made = {}, {}
    for name, groups in _axis_groups(dp, fsdp, tp, sp).items():
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
                mine = (ranks.index(world.rank), group, tuple(ranks))
        r, group, ranks = mine
        if sizes[name] == world.size:
            group = world.group
        views[name] = TPMesh(rank=r, size=sizes[name], group=group, device=world.device,
                             backend=world.backend, ranks=ranks)
    return ParallelMesh(rank=world.rank, shape={"dp": dp, "fsdp": fsdp, "tp": tp, "sp": sp},
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
