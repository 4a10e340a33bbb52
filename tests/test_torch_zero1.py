"""ZeRO-1 of the dp×fsdp×tp step (qlora_tpu_torch.parallel.sharded_step):
the flat-padded optimizer-state layout against the JAX package's byte for
byte, adam8bit under it against JAX's ``make_sharded_train_step``, and host
offload on a mesh, in one 4-rank gloo world on the CPU at (dp, fsdp, tp) =
(1, 2, 2) (tests/torch_train_worker.py; the model and bounds of
tests/test_torch_sharded_step.py)."""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qlora_tpu.lora import LoraConfig as JLoraConfig
from qlora_tpu.parallel.sharded_step import init_sharded_train_state as jinit_sharded
from qlora_tpu.parallel.sharded_step import make_sharded_train_step as jmake_sharded
from qlora_tpu.parallel.sharded_step import opt_state_full_to_zero1 as jfull_to_zero1
from qlora_tpu.parallel.sharded_step import opt_state_zero1_to_full as jzero1_to_full
from qlora_tpu.train import init_train_state as jinit_train_state
from qlora_tpu.train import make_optimizer as jmake_optimizer
from qlora_tpu.train import make_train_step as jmake_train_step
from qlora_tpu.utils import checkpoint as jck

from qlora_tpu_torch.models.config import ModelConfig
from qlora_tpu_torch.parallel import (
    Zero1Layout, opt_state_full_to_zero1, opt_state_zero1_to_full, run_ranks, zero1_chunk,
)
from qlora_tpu_torch.train import make_optimizer
from qlora_tpu_torch.train.optimizer import tree_leaves
from qlora_tpu_torch.utils.checkpoint import load_pytree
from qlora_tpu_torch.utils.convert import lora_from_numpy
from test_torch_convert import jax_to_numpy
from test_torch_sharded_step import CFG, GNORM_RTOL, LCFG, LOSS_RTOL, STEPS, _jax_run, \
    _jmesh, _problem
import torch_train_worker

torch.set_num_threads(2)
SHAPE = (1, 2, 2)


@pytest.fixture(scope="module")
def world():
    jcfg, params, lora, batch = _problem()
    common = dict(cfg=ModelConfig(**CFG), lcfg_kw=LCFG, params_np=jax_to_numpy(params),
                  lora_np=jax_to_numpy(lora), batch=batch, shape=SHAPE)
    opt8 = jmake_optimizer("adam8bit", 1e-3, total_steps=10)
    mesh = _jmesh(SHAPE)
    s8 = jinit_sharded(lora, opt8, mesh)
    ref8, _ = _jax_run(jmake_sharded(jcfg, JLoraConfig(**LCFG), opt8, mesh, params, s8,
                                     donate=False), s8, params, batch)
    cases = [("adamw", "train", common),
             ("offload", "train", dict(common, offload=True)),
             ("adam8bit", "train", dict(common, opt="adam8bit")),
             ("adam8bit-offload", "train", dict(common, opt="adam8bit", offload=True))]
    with tempfile.TemporaryDirectory() as store:
        out = run_ranks(torch_train_worker.world, 4, cases, backend="gloo",
                        devices=["cpu"] * 4, store_dir=store, timeout_s=600)
    return out, ref8, (jcfg, params, lora, batch)


def test_adam8bit_under_zero1_matches_jax(world):
    """adam8bit's blockwise state split over fsdp in whole 256-blocks:
    each step's loss and grad norm against JAX's sharded step."""
    out, ref8, _ = world
    got = out[0]["adam8bit"]
    np.testing.assert_allclose(got["loss"], ref8["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], ref8["grad_norm"], rtol=GNORM_RTOL)


@pytest.mark.parametrize("opt", ["adamw", "adam8bit"])
def test_host_offload_on_the_mesh_keeps_the_step(world, opt):
    """``--optim_host_offload`` on a mesh: each rank's ZeRO-1 chunk rests in
    host memory between steps (its optimizer wrapped by ``host_offload``);
    the losses, norms and adapters are the step's without it, bit for bit."""
    out, _, _ = world
    a, b = out[0][f"{opt}-offload" if opt == "adam8bit" else "offload"], out[0][opt]
    assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
    for name in a["lora"]:
        for k in ("a", "b"):
            assert np.array_equal(a["lora"][name][k], b["lora"][name][k])


def test_zero1_state_is_fsdp_sharded(world):
    """Under fsdp 2 each rank holds half of every flat-padded optimizer
    leaf, whose global view has JAX's shapes."""
    out, _, (_, _, lora, _) = world
    opt = jmake_optimizer("paged_adamw_32bit", 1e-3, total_steps=10)
    jz = jinit_sharded(lora, opt, _jmesh(SHAPE)).opt_state
    jmu = [np.asarray(x) for x in jax.tree_util.tree_leaves(jz[1][0].mu)]
    got = out[0]["adamw"]
    assert [v.shape for v in got["zero1_global"]["mu"].values()] == [m.shape for m in jmu]
    assert got["chunk_sizes"] == [m.size // 2 for m in jmu] * 2
    got8 = out[0]["adam8bit"]
    assert all(n % 256 == 0 for n in got8["chunk_sizes"][:len(jmu)])    # m_q: whole blocks


def _jax_state_after(name, jcfg, params, lora, batch, steps=2):
    opt = jmake_optimizer(name, 1e-3, total_steps=10)
    state = jinit_train_state(lora, opt)
    step = jmake_train_step(jcfg, JLoraConfig(**LCFG), opt, donate=False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for i in range(steps):
        state, _ = step(state, params, jb, jax.random.PRNGKey(i))
    return opt, state


@pytest.mark.parametrize("name", ["paged_adamw_32bit", "adam8bit"])
def test_zero1_layout_byte_equal_to_jax(world, tmp_path, name):
    """A single-device state JAX made, read by the port through a checkpoint
    file, converted to the flat-padded ZeRO-1 layout and back: each
    conversion byte for byte JAX's, and a rank's chunk JAX's chunk."""
    _, _, (jcfg, params, lora, batch) = world
    jopt, jstate = _jax_state_after(name, jcfg, params, lora, batch)
    path = str(tmp_path / "s.npz")
    jck.save_pytree(path, jstate.opt_state)
    port_lora = lora_from_numpy(jax_to_numpy(lora), "cpu")
    opt = make_optimizer(name, 1e-3, total_steps=10)
    full = load_pytree(path, opt.init(port_lora), params=port_lora)
    z = opt_state_full_to_zero1(full, port_lora, opt, 2)
    jz = jfull_to_zero1(jstate.opt_state, lora, jopt, 2)
    if name == "adam8bit":
        parts = ("m_q", "m_s", "sv_q", "sv_s")
        want = {p: [np.asarray(x) for x in jax.tree_util.tree_leaves(getattr(jz, p))]
                for p in parts}
        got = {p: [t.numpy() for t in z[p]] for p in parts}
    else:
        lay = Zero1Layout(port_lora, 2)
        want = {p: [np.asarray(x) for x in jax.tree_util.tree_leaves(getattr(jz[1][0], p))]
                for p in ("mu", "nu")}
        got = {p: [z[p][k].numpy() for k, _ in lay.groups] for p in ("mu", "nu")}
    for p in want:
        assert len(got[p]) == len(want[p])
        for a, b in zip(got[p], want[p]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), p
            assert all(zero1_chunk({"x": torch.from_numpy(a)}, 2, r)["x"].numpy().tobytes()
                       == b.reshape(2, -1)[r].tobytes() for r in range(2))
    # and back: JAX's zero1_to_full, written and read the port's way, equals the port's
    back = opt_state_zero1_to_full(z, port_lora, opt)
    jback = jzero1_to_full(jz, lora, jopt)
    path2 = str(tmp_path / "b.npz")
    jck.save_pytree(path2, jback)
    want_back = load_pytree(path2, opt.init(port_lora), params=port_lora)
    for a, b in zip(tree_leaves(back), tree_leaves(want_back)):
        assert a.dtype == b.dtype and a.numpy().tobytes() == b.numpy().tobytes()
    assert back["count"] == want_back["count"] == 2


def test_zero1_to_full_matches_the_gathered_state(world):
    """A rank's gathered ZeRO-1 state converted to the single-device layout
    (what a checkpoint holds) equals the conversion of the global view."""
    out, _, (_, _, lora, _) = world
    got = out[0]["adamw"]
    port_lora = lora_from_numpy(jax_to_numpy(lora), "cpu")
    opt = make_optimizer("paged_adamw_32bit", 1e-3, total_steps=10)
    glob = {"count": got["zero1_global"]["count"],
            **{p: {k: torch.from_numpy(v) for k, v in got["zero1_global"][p].items()}
               for p in ("mu", "nu")}}
    full = opt_state_zero1_to_full(glob, port_lora, opt)
    for a, b in zip(tree_leaves(full), tree_leaves(got["full_state"])):
        assert np.array_equal(a.numpy(), b)
    assert full["count"] == STEPS
