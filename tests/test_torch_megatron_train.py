"""The Megatron train step (qlora_tpu_torch.parallel.megatron_step) against
the JAX package's ``make_megatron_train_step`` and single-device step, at
(dp, tp) = (2, 2) in one 4-rank gloo world on the CPU.

Each rank (tests/torch_train_worker.py) takes the whole params JAX re-packed
with ``requantize_row_parallel`` (its row-parallel linears K-sharded over
2) and the LoRA, byte for byte, cuts its Megatron shard and runs the port's
step.  Bounds as tests/test_megatron_step.py's and test_sharded_step.py's:
loss within 2e-3 relative, grad norm within 5e-3, one SGD(1.0) step's
gradients elementwise within rtol 5e-2 and atol 2e-2 x the leaf's largest.
The collectives of a step are counted by axis for both styles on the same
mesh: Megatron makes fewer, and its only all-gathers are the embedding's
and the lm_head's (JAX's ``test_megatron_fewer_collectives_than_gather_style``
counts them in the lowered program)."""

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
from qlora_tpu.parallel.megatron_step import init_megatron_state as jinit_megatron
from qlora_tpu.parallel.megatron_step import make_megatron_train_step as jmake_megatron
from qlora_tpu.parallel.megatron_step import requantize_row_parallel as jrequantize
from qlora_tpu.train import init_train_state as jinit_train_state
from qlora_tpu.train import make_eval_step as jmake_eval_step
from qlora_tpu.train import make_optimizer as jmake_optimizer
from qlora_tpu.train import make_train_step as jmake_train_step

from qlora_tpu_torch.models.config import ModelConfig
from qlora_tpu_torch.parallel import run_ranks
from test_torch_convert import jax_to_numpy
import torch_train_worker

torch.set_num_threads(2)

# JAX's Megatron test model (tests/test_megatron_step.py): GQA heads split over tp
CFG = dict(arch="llama", vocab_size=512, hidden_size=256, intermediate_size=512,
           num_layers=2, num_heads=4, num_kv_heads=2)
LCFG = dict(r=4, alpha=8)
LOSS_RTOL, GNORM_RTOL = 2e-3, 5e-3
SHAPE = (2, 1, 2)
STEPS = 3


def _problem():
    jcfg = JModelConfig(**CFG)
    params = jrequantize(jinit_params(jax.random.PRNGKey(0), jcfg, quantized=True), 2)
    lora = jinit_lora(jax.random.PRNGKey(1), jcfg, JLoraConfig(**LCFG))
    rng = np.random.default_rng(1)
    lora = {n: {"a": ad["a"], "b": jnp.asarray(rng.normal(size=ad["b"].shape) * 0.05,
                                               jnp.float32)} for n, ad in lora.items()}
    ids = np.random.default_rng(2).integers(0, CFG["vocab_size"], (8, 16)).astype(np.int32)
    batch = {"input_ids": ids, "attention_mask": np.ones_like(ids), "labels": ids}
    return jcfg, params, lora, batch


def _run(step, state, params, batch, steps=STEPS):
    out = {"loss": [], "grad_norm": []}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for i in range(steps):
        state, m = step(state, params, jb, jax.random.PRNGKey(50 + i))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    return out, state


@pytest.fixture(scope="module")
def worlds():
    jcfg, params, lora, batch = _problem()
    lc = JLoraConfig(**LCFG)
    common = dict(cfg=ModelConfig(**CFG), lcfg_kw=LCFG, params_np=jax_to_numpy(params),
                  lora_np=jax_to_numpy(lora))
    opt = jmake_optimizer("paged_adamw_32bit", 1e-3, total_steps=10)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))
    cases, ref = [], {}
    for accum in (1, 2):
        b = batch if accum == 1 else {k: v.reshape(accum, -1, v.shape[-1])
                                      for k, v in batch.items()}
        s = jinit_megatron(lora, opt, mesh)
        ref[accum] = _run(jmake_megatron(jcfg, lc, opt, mesh, params, s, accum_steps=accum,
                                         donate=False), s, params, b)[0]
        ref[("single", accum)] = _run(jmake_train_step(jcfg, lc, opt, accum_steps=accum,
                                                       donate=False),
                                      jinit_train_state(lora, opt), params, b)[0]
        cases.append((f"megatron-{accum}", "train", dict(common, batch=b, shape=SHAPE,
                                                         style="megatron", accum=accum)))
    sgd = optax.sgd(1.0)
    s0 = jinit_train_state(lora, sgd)
    s1, _ = jmake_train_step(jcfg, lc, sgd, donate=False)(
        s0, params, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(3))
    ref["grads"] = jax.tree_util.tree_map(lambda a, b: np.asarray(a - b), s0.trainable,
                                          s1.trainable)
    ref["eval"] = jmake_eval_step(jcfg, lc)(lora, params,
                                            {k: jnp.asarray(v) for k, v in batch.items()})
    cases += [("sgd", "train", dict(common, batch=batch, shape=SHAPE, style="megatron",
                                    steps=1, opt="sgd", lr=1.0, clip_norm=None)),
              ("full", "train", dict(common, batch=batch, shape=SHAPE, style="megatron",
                                     remat="full", steps=1)),
              ("gather", "train", dict(common, batch=batch, shape=SHAPE, steps=1)),
              ("offload", "train", dict(common, batch=batch, shape=SHAPE, style="megatron",
                                        offload=True)),
              ("eval", "eval_loss", dict(common, batch=batch, shape=SHAPE, style="megatron"))]
    with tempfile.TemporaryDirectory() as store:
        out = run_ranks(torch_train_worker.world, 4, cases, backend="gloo",
                        devices=["cpu"] * 4, store_dir=store, timeout_s=600)
    return out, ref, lora


@pytest.mark.parametrize("accum", [1, 2])
def test_megatron_matches_jax_3_steps(worlds, accum):
    """Each step's loss and grad norm against JAX's Megatron step and the
    single device, the same on every rank; the adapters gathered whole
    equal on every rank."""
    out, ref, _ = worlds
    got = out[0][f"megatron-{accum}"]
    for want, tag in ((ref[accum], "JAX's Megatron step"), (ref[("single", accum)], "single")):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL, err_msg=tag)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=GNORM_RTOL,
                                   err_msg=tag)
    for o in out[1:]:
        r = o[f"megatron-{accum}"]
        assert r["loss"] == got["loss"] and r["grad_norm"] == got["grad_norm"]
        for name in got["lora"]:
            for k in ("a", "b"):
                assert np.array_equal(r["lora"][name][k], got["lora"][name][k])


def test_megatron_grads_elementwise(worlds):
    """One SGD(1.0) step without a clip: the tp-sharded halves (exact on
    their rank, summed over dp) and the replicated halves (summed over dp
    and tp) against JAX's single-device gradients."""
    out, ref, lora = worlds
    got = out[0]["sgd"]["lora"]
    for name, ad in ref["grads"].items():
        for k in ("a", "b"):
            g = np.asarray(lora[name][k]) - got[name][k]
            scale = max(np.abs(ad[k]).max(), 1e-12)
            np.testing.assert_allclose(g, ad[k], rtol=5e-2, atol=2e-2 * scale,
                                       err_msg=f"{name}/{k}")


def test_megatron_remat_full_matches(worlds):
    """Under remat "full" the recomputed blocks all-reduce their partial
    sums again; the step's loss and grad norm are the save_linear step's."""
    out, ref, _ = worlds
    got, want = out[0]["full"], ref[1]
    np.testing.assert_allclose(got["loss"], want["loss"][:1], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"][:1], rtol=GNORM_RTOL)


def test_megatron_fewer_collectives_than_gather_style(worlds):
    """A step at L = 2, accum 1, remat save_linear, rank 0, by axis.  The
    gather style: 7 L + 2 tp gathers (every linear's output, the
    embedding's, the lm_head's) and 7 L - 2 tp all-reduces (every input's
    gradient but layer 0's q, k, v, which see the frozen embedding, plus the
    lm_head's), 2 over the data axes (the micro-batch's token count and
    loss, the gradients).  Megatron: 2 L all-reduces forward (taped: the recomputed
    blocks make none), 2 L - 1 backward, the embedding's and the lm_head's
    gathers and the lm_head's all-reduce, the norm's sharded squares; 2 over
    dp and 1 over the whole world (the replicated halves' gradients)."""
    out, _, _ = worlds
    L = CFG["num_layers"]
    gather = out[0]["gather"]["collectives"][0]
    mega = out[0]["megatron-1"]["collectives"]
    assert {k: v for k, v in gather.items() if v} == {"tp": 14 * L, "data": 2}
    assert all(m == mega[0] for m in mega)
    assert {k: v for k, v in mega[0].items() if v} == {"tp": 4 * L + 3, "dp": 2, "world": 1}
    assert sum(mega[0].values()) < sum(gather.values())


def test_megatron_host_offload_keeps_the_step(worlds):
    """The tp-sharded AdamW state resting in host memory between steps:
    the same losses, norms and adapters, bit for bit."""
    out, _, _ = worlds
    a, b = out[0]["offload"], out[0]["megatron-1"]
    assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
    for name in a["lora"]:
        for k in ("a", "b"):
            assert np.array_equal(a["lora"][name][k], b["lora"][name][k])


def test_megatron_lora_state_is_tp_sharded(worlds):
    """A rank holds B's columns of the column-parallel linears and A's rows
    of the row-parallel ones (the rest whole), and half of the re-packed
    model's frozen storage."""
    out, _, lora = worlds
    for o in out:
        held = o["megatron-1"]["held_shapes"]
        for name, ad in lora.items():
            a, b = ad["a"].shape[1:], ad["b"].shape[1:]
            if name in ("wo", "w_down"):
                assert held[name] == {"a": (a[0] // 2, a[1]), "b": b}, name
            else:
                assert held[name] == {"a": a, "b": (b[0], b[1] // 2)}, name
        assert 0.5 < o["megatron-1"]["frozen_share"] < 0.51


def test_megatron_eval_matches_jax(worlds):
    out, ref, _ = worlds
    want, n = ref["eval"]
    for o in out:
        loss, got_n = o["eval"]
        assert got_n == int(n)
        np.testing.assert_allclose(loss, float(want), rtol=LOSS_RTOL)
