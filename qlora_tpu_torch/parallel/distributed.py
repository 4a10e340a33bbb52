"""The process groups of a world of ranks, on one host or several.

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

On one host, rendezvous goes through a ``FileStore`` in a directory the
caller names, never a TCP port, so that several worlds on one host cannot
collide.  Across hosts, :func:`initialize` joins one process a host through
a ``TCPStore`` that process 0 serves at the coordinator's address; each
world then meets under a key prefix of its own there, and its global ranks
are process-major.  :func:`run_ranks` starts this process's ranks of a
world and gathers what each returns.

Training runs over a mesh of named axes ``("dp", "fsdp", "tp", "sp")`` in
the JAX package's device order (``reshape(dp, fsdp, tp, sp)``, row-major:
rank = ((d·F + f)·T + t)·SP + s; without weight sharding JAX's
``reshape(dp, sp)`` is the same order).  :func:`make_parallel_mesh` gives
each axis, the joint data axes ``("dp", "fsdp")`` and the sequence-parallel
step's joint axes ``("dp", "fsdp", "sp")`` a process group of their own,
each seen by the rank as a :class:`TPMesh` (its rank on the axis, the
axis' size, ``all_reduce``, ``all_gather``, ``rotate``), so that the
conjugate operators run on any axis unchanged and the ring attention
rotates over the sp axis; GSPMD training's joint model axis ``("fsdp",
"tp")`` has one too.
"""

from __future__ import annotations

import dataclasses
import datetime
import importlib.util
import math
import os
import pickle
import time
import traceback
from typing import Callable, Optional

import numpy as np
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


def init_process_group(size: int, rank: int, *, backend: str, device,
                       store_dir: Optional[str] = None, timeout_s: float = 600.0,
                       tcp: Optional[tuple] = None) -> TPMesh:
    """Join rank `rank` of a world of `size` on `backend` ("nccl" or
    "gloo"), the rank running on `device`: through a ``FileStore`` in
    `store_dir` (one directory a world, on one host), or with `tcp` =
    (host, port, prefix) through the ``TCPStore`` that process 0 of a
    multi-process run serves (:func:`initialize`), under a key prefix of
    the world's own."""
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: one of {BACKENDS}")
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device a rank")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    if tcp is not None:
        host, port, prefix = tcp
        store = dist.PrefixStore(prefix, dist.TCPStore(host, port, is_master=False,
                                                       timeout=timeout))
    else:
        store = dist.FileStore(os.path.join(store_dir, "store"), size)
    # NCCL binds its communicators to the rank's card up front when it is
    # named (without it, the first collective guesses the device)
    extra = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, rank=rank, world_size=size, timeout=timeout,
                            **extra)
    return TPMesh(rank=rank, size=size, group=dist.group.WORLD, device=device,
                  backend=backend, ranks=tuple(range(size)))


# ---------------------------------------------------------------------------
# several processes (hosts)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ProcessInfo:
    """Where this process stands in a multi-process run: its id, the number
    of processes, the ranks (devices) each starts, and the world's ranks."""
    process_id: int
    process_count: int
    local_devices: int
    global_devices: int


# this process' place, set by initialize() in a host's parent and by
# _rank_main in each rank it starts: id, count, local ranks (None: not yet
# known), the coordinator's (host, port), the parent's store client, the
# worlds started so far
_PROCESS: dict = {}


def _parse_address(address: str) -> tuple:
    host, sep, port = address.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"coordinator_address {address!r}: expected host:port")
    return host, int(port)


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, local_device_ids: Optional[list] = None,
               timeout_s: float = 600.0) -> bool:
    """Join a run of `num_processes` processes, one a host (the JAX
    package's ``initialize``): process 0 serves a ``TCPStore`` at
    `coordinator_address` ("host:port"), every process connects to it and
    waits until all have.  Returns True when more than one process runs
    after the call; with no arguments, or one process, it starts nothing
    and returns whether an earlier call joined several.  A call that repeats
    the arguments of the one before is a no-op.

    Here a process is a host's parent: the ranks of a mesh are processes it
    starts (:func:`run_ranks`), and the world's global ranks are
    process-major, process p's local rank l being p·L + l (as JAX's
    ``jax.devices()`` is ordered by process).  `local_device_ids` names the
    devices (CUDA ordinals) this process's ranks run on; by default its
    cards.  A TPU pod's runtime discovers all of this itself; nothing here
    does, so each of the three is required once one is given."""
    if num_processes is not None and num_processes <= 1:
        return False
    if coordinator_address is None and num_processes is None:
        return process_count() > 1
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("several processes need coordinator_address, num_processes and "
                         "process_id together (no runtime discovers them)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside {num_processes} processes")
    host, port = _parse_address(coordinator_address)
    key = (host, port, num_processes, process_id)
    if _PROCESS.get("key") == key:
        return True
    if _PROCESS.get("key") is not None:
        raise RuntimeError(f"this process already joined {_PROCESS['key']}")
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, port, is_master=process_id == 0, timeout=timeout,
                          wait_for_workers=False)
    store.add("processes", 1)
    deadline = datetime.datetime.now() + timeout
    while store.add("processes", 0) < num_processes:
        if datetime.datetime.now() > deadline:
            raise RuntimeError(f"{store.add('processes', 0)} of {num_processes} processes "
                               f"reached {coordinator_address} within {timeout_s} s")
        time.sleep(0.05)
    _PROCESS.update(key=key, address=(host, port), count=num_processes, id=process_id,
                    local=None if local_device_ids is None else len(local_device_ids),
                    store=store, worlds=0)
    return True


def process_count() -> int:
    return _PROCESS.get("count", 1)


def process_index() -> int:
    return _PROCESS.get("id", 0)


def process_info() -> ProcessInfo:
    """This process's place (JAX's ``process_info``): in a host's parent
    its local devices are those `local_device_ids` named, else its cards;
    in a rank, the ranks its parent started."""
    local = _PROCESS.get("local")
    if local is None:
        local = torch.cuda.device_count()
    return ProcessInfo(process_id=process_index(), process_count=process_count(),
                       local_devices=local, global_devices=local * process_count())


def end_of_run(ok: bool = True, timeout_s: float = 3600.0) -> None:
    """The processes' last meeting, after process 0 has done what follows
    training: process 0 says it is done and waits until every other
    process has heard it (the store it serves goes when it exits); the
    others wait for that word.  No-op in a single process."""
    if process_count() <= 1:
        return
    store = _PROCESS["store"]
    store.set_timeout(datetime.timedelta(seconds=timeout_s))
    if process_index() == 0:
        store.set("run/done", "1" if ok else "0")
        deadline = time.time() + timeout_s
        while store.add("run/heard", 0) < process_count() - 1 and time.time() < deadline:
            time.sleep(0.05)
    else:
        store.wait(["run/done"])
        store.add("run/heard", 1)


def make_global_mesh(world: TPMesh, axes, model_axis: bool = False) -> "ParallelMesh":
    """The ``(dp, fsdp, tp)`` mesh over every process's ranks (JAX's
    ``make_global_mesh``): ranks process-major, dp outermost, so that when
    fsdp·tp divides a process's ranks each fsdp×tp group stays within a
    process and only the gradients' all-reduce over dp crosses hosts.
    Where a group spans processes it warns, as JAX does: the weight
    collectives then cross hosts.  `model_axis`: as in
    :func:`make_parallel_mesh`."""
    n = axes.dp * axes.fsdp * axes.tp
    if n != world.size:
        raise ValueError(f"mesh {axes} needs {n} ranks, the world has {world.size}")
    if process_count() > 1:
        local = n // process_count()
        group = axes.fsdp * axes.tp
        spans = any(len({r // local for r in range(d * group, (d + 1) * group)}) > 1
                    for d in range(axes.dp))
        if spans:
            import warnings

            warnings.warn(
                f"mesh {axes}: fsdp×tp groups span multiple processes — weight-gather/psum "
                "collectives will cross hosts (slow). Prefer fsdp*tp ≤ the ranks of a process "
                "with dp a multiple of the process count.", stacklevel=2)
    return make_parallel_mesh(world, axes.dp, axes.fsdp, axes.tp, model_axis=model_axis)


def global_batch_from_local(mesh: "ParallelMesh", local_batch: dict) -> dict:
    """The global batch, from each process's local rows (JAX's
    ``global_batch_from_local``): every process passes its own
    ``[local_B, ...]`` arrays, and every rank gets ``[local_B ×
    process_count, ...]`` in process order, which the steps slice into
    each data rank's rows.  One all-gather over the world (collective);
    in a single process the batch as it is."""
    if process_count() == 1:
        return dict(local_batch)
    world = mesh.world
    local = world.size // process_count()
    out = {}
    for k, v in local_batch.items():
        x = torch.as_tensor(np.asarray(v)).to(world.device)
        every = world.all_gather(x[None], dim=0)[::local]        # one copy a process
        out[k] = every.reshape(-1, *x.shape[1:]).cpu().numpy()
    return out


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
    (d·F + f)·SP + s of dp·F·SP), for the whole world (``world``) and,
    where the mesh was made for GSPMD training, for the joint model axis
    (``model``: rank f·T + t of F·T, fsdp-major as JAX's ``("fsdp",
    "tp")``; None otherwise)."""
    rank: int
    shape: dict
    world: TPMesh
    dp: TPMesh
    fsdp: TPMesh
    tp: TPMesh
    data: TPMesh
    sp: TPMesh
    data_sp: TPMesh
    model: Optional[TPMesh] = None

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
                for a in ("dp", "fsdp", "tp", "sp", "data", "data_sp", "model", "world")
                if self.axis(a) is not None}


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
        "model": [[r(d, f, t, s) for f in F for t in T] for d in D for s in S],
    }


def make_parallel_mesh(world: TPMesh, dp: int = 1, fsdp: int = 1, tp: int = 1,
                       sp: int = 1, model_axis: bool = False) -> ParallelMesh:
    """The ``(dp, fsdp, tp, sp)`` mesh over an initialized world of
    dp·fsdp·tp·sp ranks, with the joint model axis of GSPMD training where
    `model_axis` (the other steps never use it).  Every rank creates every
    group (``dist.new_group`` is collective over the world), in the same
    order; an axis of size 1 gets no group and its collectives are
    identities, an axis of the whole world uses the world's, and an axis
    whose ranks another axis already grouped (the data axes when the others
    are 1) shares that group."""
    if dp * fsdp * tp * sp != world.size:
        raise ValueError(f"a mesh of {dp} x {fsdp} x {tp} x {sp} needs {dp * fsdp * tp * sp} "
                         f"ranks, the world has {world.size}")
    sizes = {"dp": dp, "fsdp": fsdp, "tp": tp, "data": dp * fsdp, "sp": sp,
             "data_sp": dp * fsdp * sp, "model": fsdp * tp}
    views, made = {}, {}
    for name, groups in _axis_groups(dp, fsdp, tp, sp).items():
        if name == "model" and not model_axis:
            continue
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


# what the fork server imports once for every rank it forks: torch and the
# port, and torch._dynamo (remat's first checkpoint imports it, seconds of CPU
# a rank) where triton is absent; with triton, importing it warms a pool of
# compile workers that would outlive the server
_FORKSERVER_PRELOAD = ["torch", "qlora_tpu_torch.parallel"] + (
    ["torch._dynamo"] if importlib.util.find_spec("triton") is None else [])


def _rank_main(fn, rank, size, backend, device, store_dir, tcp, layout, args, queue):
    try:
        if layout is not None:      # this rank's process layout, for process_info()
            _PROCESS.update(id=layout[0], count=layout[1], local=layout[2])
        mesh = init_process_group(size, rank, backend=backend, device=device,
                                  store_dir=store_dir, tcp=tcp)
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
    """Run ``fn(mesh, *args)`` in new processes, one a rank of a world of
    `size`, and return their results in rank order.

    In one process it starts every rank, rank r on ``devices[r]``.  After
    :func:`initialize` joined several, it starts only this process's
    ranks, ``len(devices)`` of them (process p's local rank l is world rank
    p·L + l, on ``devices[l]``), and returns theirs; the world meets through
    process 0's store, and a rank that fails in any process ends the world
    in every process.

    `fn` must be importable by name (a module-level function) and its
    results picklable; `args` go to every rank.  With `per_rank` (a tuple
    for each rank this call starts) such a rank runs ``fn(mesh,
    *per_rank[i], *args)``: what only that rank receives (its shard, say)
    comes first.  A rank that raises ends the world: the others are stopped
    and the first traceback raised here.  The processes are forked by a
    fork server that has imported torch and the port (``_FORKSERVER_PRELOAD``)
    and touched no CUDA:
    a CUDA context does not survive ``fork``, and a fresh interpreter a rank
    (``spawn``) would import torch again for every rank (seconds of CPU
    each)."""
    import queue as queue_mod

    import torch.multiprocessing as mp

    procs_n = process_count()
    local = len(devices)
    if local * procs_n != size:
        raise ValueError(f"{local} devices a process x {procs_n} processes for {size} ranks")
    if per_rank is not None and len(per_rank) != local:
        raise ValueError(f"{len(per_rank)} per-rank argument tuples for {local} ranks")
    first = process_index() * local
    tcp = layout = failed_key = None
    store = _PROCESS.get("store")
    if procs_n > 1:
        # every process starts its worlds in the same order: the count names each
        _PROCESS["worlds"] += 1
        prefix = f"world{_PROCESS['worlds']}/"
        tcp = (*_PROCESS["address"], prefix)
        layout = (process_index(), procs_n, local)
        failed_key = prefix + "failed"
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(_FORKSERVER_PRELOAD)
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, first + i, size, backend, devices[i], store_dir, tcp, layout,
                               (tuple(per_rank[i]) if per_rank else ()) + args, q),
                         daemon=True)
             for i in range(local)]
    for p in procs:
        p.start()
    results, error = {}, None
    deadline = None if timeout_s is None else datetime.datetime.now() + \
        datetime.timedelta(seconds=timeout_s)
    try:
        while len(results) < local and error is None:
            try:
                rank, ok, payload = q.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [first + i for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and first + i not in results]
                if dead:
                    error = f"rank {dead[0]} exited with code {procs[dead[0] - first].exitcode}"
                elif failed_key is not None and store.check([failed_key]):
                    error = f"another process's rank failed:\n{store.get(failed_key).decode()}"
                elif deadline is not None and datetime.datetime.now() > deadline:
                    error = f"the world did not finish within {timeout_s} s"
                continue
            if ok:
                results[rank] = pickle.loads(payload)
            else:
                error = f"rank {rank} raised:\n{payload}"
    finally:
        if error is not None and failed_key is not None and not store.check([failed_key]):
            store.set(failed_key, f"process {process_index()}: {error}")
        for p in procs:
            if error is not None and p.is_alive():
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if error is not None:
        raise RuntimeError(error)
    return [results[first + i] for i in range(local)]
