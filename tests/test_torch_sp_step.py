"""The sequence-parallel training step (qlora_tpu_torch.parallel.sp_step)
against the JAX package's ``make_sp_train_step`` and single-device step, in
one 4-rank gloo world on the CPU (tests/torch_train_worker.py: ``train``
with the style "sp").

JAX's sp-step test model (tests/test_sp_step.py: 2 layers, 4 heads over 2
kv heads, so that GQA goes through the ring) carried to the port byte for
byte, a LoRA with nonzero B, a batch of 4 x 32 made with numpy (8 or 16
positions a shard: the flash route).  The bounds are JAX's own: each
step's loss within 2e-3 relative and grad norm within 5e-3, the adapters
after 3 AdamW steps within 8e-3 at most and 2e-4 on average of the single
device's.  JAX's sp step compiles its ring's Pallas kernels in interpret
mode, ~12 s a mesh, so each mesh holds the port against it for the first
step and against the single device for all three.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from qlora_tpu.lora import LoraConfig as JLoraConfig
from qlora_tpu.models import init_lora_params as jinit_lora
from qlora_tpu.models import init_params as jinit_params
from qlora_tpu.models.config import ModelConfig as JModelConfig
from qlora_tpu.parallel.sharded_step import init_sharded_train_state as jinit_sharded
from qlora_tpu.parallel.sharded_step import sharded_param_shardings as jshardings
from qlora_tpu.parallel.sp_step import make_sp_train_step as jmake_sp
from qlora_tpu.train import init_train_state as jinit_train_state
from qlora_tpu.train import make_optimizer as jmake_optimizer
from qlora_tpu.train import make_train_step as jmake_train_step

from qlora_tpu_torch.lora import LoraConfig
from qlora_tpu_torch.models import init_lora_params, init_params
from qlora_tpu_torch.models.config import ModelConfig
from qlora_tpu_torch.models.transformer import forward
from qlora_tpu_torch.parallel import init_sharded_train_state, make_sp_train_step, run_ranks
from qlora_tpu_torch.parallel.distributed import ParallelMesh, TPMesh
from qlora_tpu_torch.train import make_optimizer, shift_labels
from test_torch_convert import jax_to_numpy
import torch_train_worker

torch.set_num_threads(2)

CFG = dict(arch="llama", vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
           num_heads=4, num_kv_heads=2)
LCFG = dict(r=4, alpha=8)
LOSS_RTOL, GNORM_RTOL = 2e-3, 5e-3
MAX_TOL, MEAN_TOL = 8e-3, 2e-4
MESHES = [(1, 1, 1, 4), (2, 1, 1, 2), (1, 2, 1, 2), (1, 1, 2, 2)]
STEPS = 3
ACCUM_SHAPE = (2, 1, 1, 2)


def _problem():
    jcfg = JModelConfig(**CFG)
    params = jinit_params(jax.random.PRNGKey(0), jcfg, quantized=True)
    lora = jinit_lora(jax.random.PRNGKey(1), jcfg, JLoraConfig(**LCFG))
    rng = np.random.default_rng(1)
    lora = {n: {"a": ad["a"], "b": jnp.asarray(rng.normal(size=ad["b"].shape) * 0.05,
                                               jnp.float32)} for n, ad in lora.items()}
    ids = np.random.default_rng(2).integers(0, CFG["vocab_size"], (4, 32)).astype(np.int32)
    return jcfg, params, lora, {"input_ids": ids, "attention_mask": np.ones_like(ids),
                                "labels": ids}


def _jax_run(step, state, params, batch, steps):
    out = {"loss": [], "grad_norm": []}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for i in range(steps):
        state, m = step(state, params, jb, jax.random.PRNGKey(70 + i))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    return out, state


def _jax_sp_first_step(jcfg, params, lora, opt, batch, shape):
    """JAX's sp step on `shape`'s mesh, one step (the first compile of each
    mesh costs ~12 s; the second step's input layout compiles again)."""
    dp, fsdp, tp, sp = shape
    if fsdp == 1 and tp == 1:
        mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(dp, sp), ("dp", "sp"))
        s, p = jinit_train_state(lora, opt), params
    else:
        mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(shape), ("dp", "fsdp", "tp", "sp"))
        s = jinit_sharded(lora, opt, mesh)
        p = jax.tree_util.tree_map(jax.device_put, params, jshardings(params, mesh))
    step = jmake_sp(jcfg, JLoraConfig(**LCFG), opt, mesh, p, s, donate=False)
    return _jax_run(step, s, p, batch, 1)[0]


@pytest.fixture(scope="module")
def world():
    jcfg, params, lora, batch = _problem()
    opt = jmake_optimizer("paged_adamw_32bit", 1e-3, total_steps=10)
    common = dict(cfg=ModelConfig(**CFG), lcfg_kw=LCFG, params_np=jax_to_numpy(params),
                  lora_np=jax_to_numpy(lora), style="sp", remat="full")
    ref = {}
    single, s_end = _jax_run(jmake_train_step(jcfg, JLoraConfig(**LCFG), opt, donate=False),
                             jinit_train_state(lora, opt), params, batch, STEPS)
    ref["single"] = (single, jax_to_numpy(s_end.trainable))
    acc_batch = {k: v.reshape(2, 2, -1) for k, v in batch.items()}
    single, s_end = _jax_run(jmake_train_step(jcfg, JLoraConfig(**LCFG), opt, accum_steps=2,
                                              donate=False),
                             jinit_train_state(lora, opt), params, acc_batch, STEPS)
    ref["single-accum"] = (single, jax_to_numpy(s_end.trainable))
    cases = []
    for shape in MESHES:
        ref[shape] = _jax_sp_first_step(jcfg, params, lora, opt, batch, shape)
        cases.append((str(shape), "train", dict(common, batch=batch, shape=shape)))
    cases.append(("accum", "train", dict(common, batch=acc_batch, shape=ACCUM_SHAPE, accum=2)))
    cases.append(("save_linear", "train", dict(common, batch=batch, shape=MESHES[0],
                                               remat="save_linear")))
    with tempfile.TemporaryDirectory() as store:
        out = run_ranks(torch_train_worker.world, 4, cases, backend="gloo",
                        devices=["cpu"] * 4, store_dir=store, timeout_s=600)
    return out, ref


def _adapters_close(got, want, tag):
    for name in want:
        for part in ("a", "b"):
            d = np.abs(np.asarray(got[name][part]) - np.asarray(want[name][part]))
            assert d.max() < MAX_TOL and d.mean() < MEAN_TOL, (tag, name, part, d.max(), d.mean())


@pytest.mark.parametrize("shape", MESHES)
def test_sp_step_matches_jax_sp_step_and_single_device(world, shape):
    """Step 1's loss and grad norm against JAX's sp step on the same mesh;
    every step's against JAX's single device, and the adapters after 3
    AdamW steps within JAX's tail bounds of the single device's; every
    rank reports the same numbers and holds the same adapters."""
    out, ref = world
    runs = [o[str(shape)] for o in out]
    single, adapters = ref["single"]
    for r in runs:
        assert r["loss"] == runs[0]["loss"] and r["grad_norm"] == runs[0]["grad_norm"]
        np.testing.assert_allclose(r["loss"][:1], ref[shape]["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["grad_norm"][:1], ref[shape]["grad_norm"], rtol=GNORM_RTOL)
        np.testing.assert_allclose(r["loss"], single["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["grad_norm"], single["grad_norm"], rtol=GNORM_RTOL)
        for name in r["lora"]:
            for part in ("a", "b"):
                np.testing.assert_array_equal(r["lora"][name][part],
                                              runs[0]["lora"][name][part])
    _adapters_close(runs[0]["lora"], adapters, shape)
    assert runs[0]["loss"][-1] < runs[0]["loss"][0]


def test_sp_step_accumulation_matches_single_device(world):
    """Two micro-batches a step at (2, 1, 1, 2), against JAX's single device
    accumulating the same two."""
    out, ref = world
    single, adapters = ref["single-accum"]
    for o in out:
        np.testing.assert_allclose(o["accum"]["loss"], single["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(o["accum"]["grad_norm"], single["grad_norm"], rtol=GNORM_RTOL)
    _adapters_close(out[0]["accum"]["lora"], adapters, "accum")


def test_sp_collectives_a_step(world):
    """The collectives of a step by axis on every rank.  Each layer's ring
    rotates n - 1 times forward, and backward n - 1 times (k, v) and n
    times (the dk, dv accumulators): 3 + 7 at sp 4, 1 + 3 at sp 2; remat
    "full" runs the forward again (13, 5); under "save_linear" the taped
    ring rotates nothing when its block is recomputed (10) and gives the
    numbers of "full".  The data axes (dp, fsdp, sp) sum the token count
    once a micro-batch and the gradients once a step; only the axes the
    mesh splits make collectives."""
    out, _ = world
    L = CFG["num_layers"]
    full_rot = {4: 13, 2: 5}
    for o in out:
        for shape in MESHES:
            for c in o[str(shape)]["collectives"]:
                assert c["sp"] == L * full_rot[shape[3]], (shape, c)
                assert c["data_sp"] == 2, (shape, c)
                assert (c["fsdp"] > 0) == (shape[1] > 1) and (c["tp"] > 0) == (shape[2] > 1)
        for c in o["save_linear"]["collectives"]:
            assert c["sp"] == L * 10 and c["data_sp"] == 2
        for c in o["accum"]["collectives"]:
            assert c["sp"] == 2 * L * full_rot[ACCUM_SHAPE[3]] and c["data_sp"] == 3
        full = o[str(MESHES[0])]
        np.testing.assert_allclose(o["save_linear"]["loss"], full["loss"], rtol=1e-6)
        np.testing.assert_allclose(o["save_linear"]["grad_norm"], full["grad_norm"], rtol=1e-6)


def test_zero1_state_is_a_chunk_a_rank(world):
    """(1, 2, 1, 2): each rank holds its fsdp chunk of AdamW's moments (the
    flat-padded layout of the sharded step); the global view gathered back
    is the single-device layout."""
    out, _ = world
    sizes = [o[str((1, 2, 1, 2))]["chunk_sizes"] for o in out]
    assert all(s == sizes[0] for s in sizes)
    full = out[0][str((1, 2, 1, 2))]["full_state"]
    assert set(full) == {"count", "mu", "nu"}


def test_sp_loss_counts_every_shard_boundary():
    """The labels are shifted over the whole sequence before it is cut: the
    last position of every shard but the last predicts the next shard's
    first token, and only the sequence's last position is ignored."""
    labels = torch.arange(8)[None].repeat(2, 1)
    shifted = shift_labels(labels)
    assert shifted[0].tolist() == [1, 2, 3, 4, 5, 6, 7, -100]
    assert shift_labels(labels[None]).shape == (1, 2, 8)


def test_sliding_window_under_sp_raises():
    """C12: JAX's ring has no window, so a sliding-window model under sp
    would attend the whole sequence there; the port refuses it before any
    collective, in the forward and through the step."""
    cfg = ModelConfig(**dict(CFG, sliding_window=8))
    params = init_params(cfg, 0, device="cpu")
    lora = init_lora_params(cfg, LoraConfig(**LCFG), 1, device="cpu")
    view = lambda n: TPMesh(rank=0, size=n, group=None, device=torch.device("cpu"),
                            backend="gloo")
    ids = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="sliding_window"):
        forward(params, lora, ids, cfg, LoraConfig(**LCFG), sp=view(2))
    mesh = ParallelMesh(rank=0, shape={"dp": 1, "fsdp": 1, "tp": 1, "sp": 2}, world=view(2),
                        dp=view(1), fsdp=view(1), tp=view(1), data=view(1), sp=view(2),
                        data_sp=view(2))
    opt = make_optimizer("paged_adamw_32bit", 1e-3, total_steps=10)
    step = make_sp_train_step(cfg, LoraConfig(**LCFG), opt, mesh)
    state = init_sharded_train_state(lora, opt, mesh)
    batch = {"input_ids": np.zeros((1, 16), np.int64), "labels": np.zeros((1, 16), np.int64)}
    with pytest.raises(ValueError, match="sliding_window"):
        step(state, params, batch)
