"""Ring attention (qlora_tpu_torch.ops.ring_attention) over the sp axis of a
4-rank gloo world on the CPU, against the JAX package's ``ring_attention``
under ``shard_map`` on the conftest's virtual devices (jitted; its flash
route in interpret mode) and against the port's single-rank
``flash_attention`` over the whole sequence.

Every case runs in one world (tests/torch_train_worker.py: ``ring``,
``rotations``, ``sp_groups``).  The inputs are made with numpy and rounded
to bf16, which both packages compute with.  Tolerances: JAX's own test
holds its ring to an f32 reference at 2e-4 (outputs) and 5e-4 + 5e-3
relative (gradients) on f32 inputs; here the operands, the probabilities
and the outputs are bf16 in both packages (the port's kernels and their
plain versions take bf16 only), whose ulp is 2^-8 of a value, so each
output is held within RING_TOL = 1e-2 (between two and three ulps) of its
tensor's largest |value|, the same for every gradient.
"""

import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from qlora_tpu.ops.ring_attention import ring_attention as jring

from qlora_tpu_torch.ops import flash_attention
from qlora_tpu_torch.ops.ring_attention import _chunks, _flash_gate
from qlora_tpu_torch.parallel import distributed, mesh_coords, run_ranks
from qlora_tpu_torch.parallel.distributed import TPMesh, _axis_groups
import torch_train_worker

torch.set_num_threads(2)
RING_TOL = 1e-2
B, H, S, D = 2, 4, 64, 64          # 16 positions a shard at sp 4
KVH_GQA = 2
CASES = [(impl, causal) for impl in ("flash", "plain") for causal in (True, False)]
SP4 = (1, 1, 1, 4)


def _inputs(kvh, seed):
    rng = np.random.default_rng(seed)
    bf = lambda *s: np.asarray(jnp.asarray(rng.normal(size=s), jnp.bfloat16), np.float32)
    return bf(B, H, S, D), bf(B, kvh, S, D), bf(B, kvh, S, D), bf(B, H, S, D)


def _jax_ring(q, k, v, do, causal, impl):
    """JAX's ring on 4 virtual devices (k, v repeated to H heads first, as
    JAX's model does): the output and the gradients, k's and v's summed
    over each group back to their kv heads."""
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("sp",))
    f = shard_map(functools.partial(jring, axis_name="sp", sm_scale=D ** -0.5, causal=causal,
                                    impl="jnp" if impl == "plain" else "flash"),
                  mesh=mesh, in_specs=(P(None, None, "sp", None),) * 3,
                  out_specs=P(None, None, "sp", None), check_rep=False)
    G = H // k.shape[1]

    def fg(q, k, v, do):
        rep = lambda t: jnp.repeat(t, G, axis=1)
        o, vjp = jax.vjp(lambda q, k, v: f(q, rep(k), rep(v)), q, k, v)
        return (o, *vjp(do))

    bf = lambda x: jnp.asarray(x, jnp.bfloat16)
    return [np.asarray(t, np.float32) for t in jax.jit(fg)(bf(q), bf(k), bf(v), bf(do))]


def _single(q, k, v, do, causal):
    """The port's flash attention on the whole sequence, one rank."""
    leaves = [torch.tensor(x).to(torch.bfloat16).requires_grad_(True) for x in (q, k, v)]
    o = flash_attention(*leaves, torch.full((B,), S, dtype=torch.int32), D ** -0.5, causal)
    o.backward(torch.tensor(do).to(torch.bfloat16))
    return [t.detach().float().numpy() for t in (o, *(x.grad for x in leaves))]


@pytest.fixture(scope="module")
def world():
    cases, inputs = [], {}
    for kvh, tag in ((H, "mha"), (KVH_GQA, "gqa")):
        inputs[tag] = _inputs(kvh, seed=7 if tag == "mha" else 8)
        q, k, v, do = inputs[tag]
        for impl, causal in CASES:
            if tag == "gqa" and not causal:
                continue
            cases.append((f"{tag}-{impl}-{causal}", "ring",
                          dict(q=q, k=k, v=v, do=do, shape=SP4, causal=causal, impl=impl)))
    # a ring of 2 on each dp rank: the peers are world ranks of the sp group
    q, k, v, do = inputs["mha"]
    cases.append(("dp2-sp2", "ring", dict(q=q, k=k, v=v, do=do, shape=(2, 1, 1, 2))))
    cases.append(("rotations", "rotations", {}))
    cases.append(("groups", "sp_groups", {}))
    with tempfile.TemporaryDirectory() as store:
        out = run_ranks(torch_train_worker.world, 4, cases, backend="gloo",
                        devices=["cpu"] * 4, store_dir=store, timeout_s=600)
    return out, inputs


def _whole(out, name):
    """Every rank's shard of each result, in sp order along the sequence."""
    parts = sorted((o[name] for o in out), key=lambda r: r["sp_rank"])
    return [np.concatenate([p[key] for p in parts], axis=2) for key in ("o", "dq", "dk", "dv")]


def _close(got, want, tag):
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        err = np.abs(a - b).max()
        assert err <= RING_TOL * np.abs(b).max(), (tag, name, err, np.abs(b).max())


@pytest.mark.parametrize("impl,causal", CASES)
def test_ring_matches_jax_ring(world, impl, causal):
    """Output and the gradients of q, k and v against JAX's ring on the same
    shards (impl "flash" against JAX's flash route, "plain" against its
    online-softmax route)."""
    out, inputs = world
    q, k, v, do = inputs["mha"]
    _close(_whole(out, f"mha-{impl}-{causal}"), _jax_ring(q, k, v, do, causal, impl),
           (impl, causal))


@pytest.mark.parametrize("impl,causal", CASES)
def test_ring_matches_single_rank_flash(world, impl, causal):
    """The same against the port's flash attention over the whole sequence
    on one rank."""
    out, inputs = world
    _close(_whole(out, f"mha-{impl}-{causal}"), _single(*inputs["mha"], causal), (impl, causal))


@pytest.mark.parametrize("impl", ["flash", "plain"])
def test_gqa_ring_rotates_kv_heads_unrepeated(world, impl):
    """k and v with 2 heads for 4 query heads rotate as they are; against
    JAX's ring on the repeated heads (its model repeats them) with the
    groups' gradients summed, and against the single rank."""
    out, inputs = world
    got = _whole(out, f"gqa-{impl}-True")
    assert got[2].shape == (B, KVH_GQA, S, D)
    _close(got, _jax_ring(*inputs["gqa"], True, impl), impl)
    _close(got, _single(*inputs["gqa"], True), impl)


def test_ring_rotation_counts(world):
    """Flash route: n - 1 rotations of k, v forward, n - 1 again backward
    and n of the travelling dk, dv accumulators (10 at n = 4) on every
    rank, whatever its causal work; plain route: n - 1 forward, n - 1
    inverse ones backward."""
    out, _ = world
    for o in out:
        for impl, causal in CASES:
            assert o[f"mha-{impl}-{causal}"]["rotations"] == (10 if impl == "flash" else 6)
        assert o["dp2-sp2"]["rotations"] == 4


def test_ring_on_a_sub_axis(world):
    """(dp, fsdp, tp, sp) = (2, 1, 1, 2): each dp rank's ring of 2 over its
    own sp group gives the whole sequence's attention."""
    out, inputs = world
    want = _single(*inputs["mha"], True)
    for d in range(2):
        ranks = [r for r in range(4) if mesh_coords(r, 2, 1, 1, 2)[0] == d]
        _close(_whole([out[r] for r in ranks], "dp2-sp2"), want, d)


def test_rotation_sends_on_and_back(world):
    """A rotation by +1 delivers rank (s - 1)'s tensors to sp rank s, by -1
    rank (s + 1)'s, with their shapes and dtypes (a bf16 tensor of odd size
    included); two in flight at once; one count each."""
    out, _ = world
    for shape in ((1, 1, 1, 4), (1, 1, 2, 2)):
        n = shape[3]
        for r, o in enumerate(out):
            got = o["rotations"][shape]
            s = r % n
            for way, shift in enumerate((1, -1)):
                src = r - s + (s - shift) % n
                assert got["got"][way] == [[float(src)] * 3,
                                           [float(x + 10 * src) for x in range(5)],
                                           [[float(src)] * 2] * 2], (shape, r, shift)
            assert got["count"] == 2
            assert got["shapes"] == [((3,), "torch.bfloat16"), ((5,), "torch.float32"),
                                     ((2, 2), "torch.int32")]


def test_mesh_groups_with_sp_follow_jax_device_order(world):
    """Rank (d, f, t, s) = ((d F + f) T + t) SP + s, as ``reshape(dp, fsdp,
    tp, sp)`` of JAX's devices (``reshape(dp, sp)`` without weight
    sharding: the same order); each axis' group, the data axes (dp, fsdp)
    and the sp step's (dp, fsdp, sp) gather their ranks in axis order."""
    out, _ = world
    for shape in ((1, 1, 1, 4), (2, 1, 1, 2), (1, 2, 1, 2), (1, 1, 2, 2)):
        grid = np.arange(4).reshape(shape)
        for r, o in enumerate(out):
            d, f, t = mesh_coords(r, *shape)
            s = r % shape[3]
            assert grid[d, f, t, s] == r
            want = {"dp": grid[:, f, t, s], "fsdp": grid[d, :, t, s], "tp": grid[d, f, :, s],
                    "sp": grid[d, f, t, :], "data": grid[:, :, t, s].reshape(-1),
                    "data_sp": grid[:, :, t, :].reshape(-1)}
            for a, ranks in want.items():
                rank, size, gathered = o["groups"][shape][a]
                assert size == len(ranks) and ranks[rank] == r, (shape, a)
                assert gathered == [float(x) for x in ranks], (shape, a)


@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 2, 1), (2, 1, 2), (2, 2, 2), (1, 4, 2),
                                   (4, 1, 1)])
def test_sp_1_makes_the_groups_of_a_3d_mesh(monkeypatch, shape):
    """With sp = 1 the mesh creates the groups a (dp, fsdp, tp) mesh always
    made, in the same order (the calls to ``new_group`` recorded): the dp,
    fsdp, tp and data groups of ``reshape(dp, fsdp, tp)``, nothing more."""
    made = []
    monkeypatch.setattr(distributed.dist, "new_group", lambda ranks: made.append(ranks) or
                        len(made))
    n = int(np.prod(shape))
    world = TPMesh(rank=0, size=n, group="world", device=torch.device("cpu"), backend="gloo")
    mesh = distributed.make_parallel_mesh(world, *shape)
    grid = np.arange(n).reshape(shape)
    dp, fsdp, tp = shape
    want, seen = [], set()
    axes = [("dp", [grid[:, f, t] for f in range(fsdp) for t in range(tp)]),
            ("fsdp", [grid[d, :, t] for d in range(dp) for t in range(tp)]),
            ("tp", [grid[d, f, :] for d in range(dp) for f in range(fsdp)]),
            ("data", [grid[:, :, t].reshape(-1) for t in range(tp)])]
    for _, groups in axes:
        for g in groups:
            if 1 < len(g) < n and tuple(g) not in seen:
                seen.add(tuple(g))
                want.append(g.tolist())
    assert made == want
    assert mesh.shape == {"dp": dp, "fsdp": fsdp, "tp": tp, "sp": 1}
    assert mesh.sp.size == 1 and mesh.data_sp.ranks == mesh.data.ranks
    assert _axis_groups(dp, fsdp, tp) == _axis_groups(dp, fsdp, tp, 1)


def test_causal_chunks_and_the_flash_gate():
    """Rank s computes chunks at steps 0..s (the diagonal causal, the
    earlier shards whole) under causality, every step otherwise; JAX's
    gate: head dim % 64 and both shards % 8."""
    assert _chunks(0, 4, True) == [(0, 0, True)]
    assert _chunks(2, 4, True) == [(0, 2, True), (1, 1, False), (2, 0, False)]
    assert _chunks(3, 4, True) == [(0, 3, True), (1, 2, False), (2, 1, False), (3, 0, False)]
    assert _chunks(1, 4, False) == [(0, 1, False), (1, 0, False), (2, 3, False),
                                    (3, 2, False)]
    z = lambda *s: torch.zeros(s)
    assert _flash_gate(z(1, 2, 16, 64), z(1, 2, 16, 64))
    assert not _flash_gate(z(1, 2, 16, 80), z(1, 2, 16, 80))
    assert not _flash_gate(z(1, 2, 12, 64), z(1, 2, 12, 64))
