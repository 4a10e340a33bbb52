"""The dp×fsdp×tp training step (qlora_tpu_torch.parallel.sharded_step)
against the JAX package's ``make_sharded_train_step`` and single-device
step, in one 4-rank gloo world on the CPU.

Each rank is a process (tests/torch_train_worker.py) that takes the whole
params and LoRA carried from JAX byte for byte, cuts its shard and runs the
port's step; JAX runs on the conftest's virtual CPU devices.  The bounds
are JAX's own (tests/test_sharded_step.py): each step's loss within 2e-3
relative, its grad norm within 5e-3, each gradient (one SGD(1.0) step, no
clip: the parameter's change is minus its gradient) elementwise within
rtol 5e-2 and atol 2e-2 x the leaf's largest |gradient|, the adapters after
3 AdamW steps within 8e-3 at most and 2e-4 on average.  The ZeRO-1 layout,
adam8bit under it and host offload on a mesh: tests/test_torch_zero1.py.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from qlora_tpu.lora import LoraConfig as JLoraConfig
from qlora_tpu.models import init_lora_params as jinit_lora
from qlora_tpu.models import init_params as jinit_params
from qlora_tpu.models.config import ModelConfig as JModelConfig
from qlora_tpu.parallel.sharded_step import init_sharded_train_state as jinit_sharded
from qlora_tpu.parallel.sharded_step import make_sharded_train_step as jmake_sharded
from qlora_tpu.train import init_train_state as jinit_train_state
from qlora_tpu.train import make_optimizer as jmake_optimizer
from qlora_tpu.train import make_train_step as jmake_train_step

from qlora_tpu_torch.models.config import ModelConfig
from qlora_tpu_torch.parallel import mesh_coords, run_ranks
from qlora_tpu_torch.parallel import distributed
from qlora_tpu_torch.parallel.distributed import _axis_groups
from test_torch_convert import jax_to_numpy
import torch_train_worker

torch.set_num_threads(2)

# JAX's sharded-step test model (tests/test_sharded_step.py)
CFG = dict(arch="llama", vocab_size=512, hidden_size=256, intermediate_size=512,
           num_layers=2, num_heads=4, num_kv_heads=4)
LCFG = dict(r=4, alpha=8)
LOSS_RTOL, GNORM_RTOL = 2e-3, 5e-3
MESHES = [(1, 2, 2), (2, 2, 1), (2, 1, 2)]
STEPS = 3


def _problem():
    """JAX params, a JAX LoRA with nonzero B (so A's gradient shows), a
    batch of 8 x 16 made with numpy."""
    jcfg = JModelConfig(**CFG)
    params = jinit_params(jax.random.PRNGKey(0), jcfg, quantized=True)
    lora = jinit_lora(jax.random.PRNGKey(1), jcfg, JLoraConfig(**LCFG))
    rng = np.random.default_rng(1)
    lora = {n: {"a": ad["a"], "b": jnp.asarray(rng.normal(size=ad["b"].shape) * 0.05,
                                               jnp.float32)} for n, ad in lora.items()}
    ids = np.random.default_rng(2).integers(0, CFG["vocab_size"], (8, 16)).astype(np.int32)
    batch = {"input_ids": ids, "attention_mask": np.ones_like(ids), "labels": ids}
    return jcfg, params, lora, batch


def _stacked(batch, accum):
    return batch if accum == 1 else {k: v.reshape(accum, -1, v.shape[-1]) for k, v in batch.items()}


def _jax_run(step, state, params, batch, steps=STEPS):
    out = {"loss": [], "grad_norm": []}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for i in range(steps):
        state, m = step(state, params, jb, jax.random.PRNGKey(50 + i))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    return out, state


def _jmesh(shape):
    return Mesh(np.asarray(jax.devices()[:4]).reshape(shape), ("dp", "fsdp", "tp"))


@pytest.fixture(scope="module")
def worlds():
    """Every case in one world of 4 ranks; what JAX computes on the same inputs."""
    jcfg, params, lora, batch = _problem()
    pnp, lnp = jax_to_numpy(params), jax_to_numpy(lora)
    cfg = ModelConfig(**CFG)
    common = dict(cfg=cfg, lcfg_kw=LCFG, params_np=pnp, lora_np=lnp)
    cases, ref = [], {}
    opt = jmake_optimizer("paged_adamw_32bit", 1e-3, total_steps=10)
    for accum in (1, 2):
        b = _stacked(batch, accum)
        single, s_ref = _jax_run(jmake_train_step(jcfg, JLoraConfig(**LCFG), opt,
                                                  accum_steps=accum, donate=False),
                                 jinit_train_state(lora, opt), params, b)
        ref[("single", accum)] = single
        ref[("single_state", accum)] = s_ref
        for shape in MESHES:
            cases.append((f"{shape}-{accum}", "train",
                          dict(common, batch=b, shape=shape, accum=accum)))
            if accum == 2:
                continue             # JAX's own accumulation test holds it to the single device
            mesh = _jmesh(shape)
            s = jinit_sharded(lora, opt, mesh)
            got, s_end = _jax_run(jmake_sharded(jcfg, JLoraConfig(**LCFG), opt, mesh, params, s,
                                                accum_steps=accum, donate=False),
                                  s, params, b)
            ref[(shape, accum)] = (got, jax_to_numpy(s_end.trainable))
    # one SGD(1.0) step without a clip: the change of each adapter is its gradient
    sgd = optax.sgd(1.0)
    s0 = jinit_train_state(lora, sgd)
    s1, _ = jmake_train_step(jcfg, JLoraConfig(**LCFG), sgd, donate=False)(
        s0, params, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(3))
    ref["grads"] = jax.tree_util.tree_map(lambda a, b: np.asarray(a - b), s0.trainable,
                                          s1.trainable)
    for shape in ((1, 2, 2), (2, 1, 2)):
        cases.append((f"sgd{shape}", "train", dict(common, batch=batch, shape=shape, steps=1,
                                                   opt="sgd", lr=1.0, clip_norm=None)))
    # the dp x tp entry point, remat "full" and no remat
    cases.append(("tp_step", "train", dict(common, batch=batch, shape=(2, 1, 2),
                                           via_tp_step=True)))
    for remat in ("full", False):
        cases.append((f"remat-{remat}", "train", dict(common, batch=batch, shape=(1, 2, 2),
                                                      remat=remat)))
    cases.append(("eval", "eval_loss", dict(common, batch=batch, shape=(1, 2, 2))))
    cases.append(("groups", "groups", {}))
    with tempfile.TemporaryDirectory() as store:
        out = run_ranks(torch_train_worker.world, 4, cases, backend="gloo",
                        devices=["cpu"] * 4, store_dir=store, timeout_s=600)
    return out, ref, (jcfg, params, lora, batch)


def _close(got, want, tag):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL, err_msg=tag)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=GNORM_RTOL, err_msg=tag)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("shape", MESHES)
def test_sharded_step_matches_jax_3_steps(worlds, shape, accum):
    """Each step's loss and grad norm against JAX's shard_map step on the
    same mesh (without accumulation: JAX's own accumulation test holds its
    step to the single device, as this one does) and against the single
    device; every rank reports the same numbers; the adapters after 3 steps
    within JAX's own tail bounds of JAX's sharded step's (accumulating: of
    JAX's single device's)."""
    out, ref, _ = worlds
    ranks = [o[f"{shape}-{accum}"] for o in out]
    got = ranks[0]
    if (shape, accum) in ref:
        jsh, jlora = ref[(shape, accum)]
        _close(got, jsh, f"{shape} accum {accum} vs JAX's sharded step")
    else:
        jlora = jax_to_numpy(ref[("single_state", accum)].trainable)
    _close(got, ref[("single", accum)], f"{shape} accum {accum} vs the single device")
    assert all(r["loss"] == got["loss"] and r["grad_norm"] == got["grad_norm"] for r in ranks)
    for name, ad in jlora.items():
        for k in ("a", "b"):
            d = np.abs(got["lora"][name][k] - ad[k])
            assert d.max() < 8e-3 and d.mean() < 2e-4, (name, k, d.max(), d.mean())
            assert all(np.array_equal(r["lora"][name][k], got["lora"][name][k]) for r in ranks)


@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 1, 2)])
def test_sharded_grads_elementwise(worlds, shape):
    """One SGD(1.0) step without a clip: the adapters' change is minus the
    gradient of the global mean loss, against JAX's single device."""
    out, ref, (_, _, lora, _) = worlds
    got = out[0][f"sgd{shape}"]["lora"]
    for name, ad in ref["grads"].items():
        for k in ("a", "b"):
            g_ref = ad[k]
            g = np.asarray(lora[name][k]) - got[name][k]
            scale = max(np.abs(g_ref).max(), 1e-12)
            np.testing.assert_allclose(g, g_ref, rtol=5e-2, atol=2e-2 * scale,
                                       err_msg=f"{shape} {name}/{k}")


@pytest.mark.parametrize("case", ["tp_step", "remat-full", "remat-False"])
def test_tp_step_and_remat_policies(worlds, case):
    """make_tp_train_step on a dp x tp mesh, and the gather style under remat
    "full" and no remat (the recomputed block makes its collectives again),
    against JAX's steps."""
    out, ref, _ = worlds
    shape = (2, 1, 2) if case == "tp_step" else (1, 2, 2)
    _close(out[0][case], ref[(shape, 1)][0], case)


def test_frozen_storage_shrinks_with_the_mesh(worlds):
    """A rank's frozen storage is 1/(fsdp tp) of the model's (the norms
    whole), as JAX's ``test_packed_weight_shards_shrink_with_mesh``."""
    out, _, _ = worlds
    for shape in MESHES:
        for o in out:
            share = o[f"{shape}-1"]["frozen_share"]
            n = shape[1] * shape[2]
            assert 1 / n < share < 1.02 / n, (shape, share)


def test_sharded_eval_matches_single_device(worlds):
    """The sharded eval step on every rank (the whole batch) against JAX's
    single-device loss."""
    out, ref, (jcfg, params, lora, batch) = worlds
    from qlora_tpu.train import make_eval_step as jmake_eval_step

    want, n = jmake_eval_step(jcfg, JLoraConfig(**LCFG))(
        lora, params, {k: jnp.asarray(v) for k, v in batch.items()})
    for o in out:
        loss, got_n = o["eval"]
        assert got_n == int(n)
        np.testing.assert_allclose(loss, float(want), rtol=LOSS_RTOL)


def test_mesh_groups_follow_jax_device_order(worlds):
    """Rank (d, f, t) = (d F + f) T + t, as ``reshape(dp, fsdp, tp)`` of
    JAX's devices; every axis' group gathers its ranks in axis order."""
    out, _, _ = worlds
    for shape in ((1, 2, 2), (2, 2, 1), (2, 1, 2), (4, 1, 1), (1, 4, 1), (1, 1, 4)):
        grid = np.arange(4).reshape(shape)
        for r, o in enumerate(out):
            d, f, t = mesh_coords(r, *shape)
            assert grid[d, f, t] == r
            want = {"dp": grid[:, f, t], "fsdp": grid[d, :, t], "tp": grid[d, f, :],
                    "data": grid[:, :, t].reshape(-1)}
            for a, ranks in want.items():
                rank, size, gathered = o["groups"][shape][a]
                assert size == len(ranks) and ranks[rank] == r
                assert gathered == [float(x) for x in ranks], (shape, a)
    assert _axis_groups(1, 2, 2)["tp"] == [[0, 1], [2, 3]]


def test_init_process_group_names_the_device_to_nccl(monkeypatch, tmp_path):
    """NCCL gets the rank's device (``device_id``), gloo does not; no
    process group is made (the calls are recorded)."""
    seen = []
    monkeypatch.setattr(distributed.dist, "FileStore", lambda path, n: ("store", path, n))
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda backend, **kw: seen.append((backend, kw)))
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: seen.append(("set_device", d)))
    distributed.init_process_group(2, 1, backend="nccl", device="cuda:1", store_dir=str(tmp_path))
    distributed.init_process_group(2, 0, backend="gloo", device="cpu", store_dir=str(tmp_path))
    assert seen[0] == ("set_device", torch.device("cuda:1"))
    backend, kw = seen[1]
    assert backend == "nccl" and kw["device_id"] == torch.device("cuda:1")
    assert kw["rank"] == 1 and kw["world_size"] == 2
    backend, kw = seen[2]
    assert backend == "gloo" and "device_id" not in kw
    with pytest.raises(ValueError, match="nccl"):
        distributed.init_process_group(2, 0, backend="nccl", device="cpu",
                                       store_dir=str(tmp_path))
