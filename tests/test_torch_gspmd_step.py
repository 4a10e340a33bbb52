"""The GSPMD step (qlora_tpu_torch.parallel.gspmd_step) against the JAX
package's single-device ``make_train_step``, which XLA partitions under
the same rules, in one 4-rank gloo world on the CPU.

Each rank (tests/torch_train_worker.py: ``gspmd``) takes the whole tree
carried from JAX byte for byte, cuts its slice (``parallel/mesh.py``) and
runs the port's step at (dp, fsdp, tp) = (2, 1, 2) and (1, 2, 2).  The
bounds are JAX's for its sharded steps: each step's loss within 2e-3
relative and its grad norm within 5e-3 of JAX's single device, in
``mode="full"`` over the dense model (accumulating too) and in
``mode="lora"`` over NF4.  The gradients the optimizer gets, gathered
from the ranks, lie within 5 % of their norm of JAX's (the single card's
bound, tests/test_torch_train.py); an AdamW update of the mesh within
2 % of its norm of the update optax's AdamW makes from the same
gradients (its moments are bf16, the port's f32: ROADMAP C7).  Whole
tensors (norms, adapters) are bit-equal on every rank and a shard on its
dp replicas; a rank holds 1/(fsdp·tp) of the trainable model and of its
moments."""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qlora_tpu.lora import LoraConfig as JLoraConfig
from qlora_tpu.models import init_lora_params as jinit_lora
from qlora_tpu.models import init_params as jinit_params
from qlora_tpu.models.config import ModelConfig as JModelConfig
from qlora_tpu.train import init_train_state as jinit_train_state
from qlora_tpu.train import make_optimizer as jmake_optimizer
from qlora_tpu.train import make_train_step as jmake_train_step
from qlora_tpu.train.step import loss_fn as jloss_fn

from qlora_tpu_torch.models.config import ModelConfig
from qlora_tpu_torch.parallel import run_ranks
from qlora_tpu_torch.train.optimizer import tree_leaves
from qlora_tpu_torch.utils.convert import params_from_numpy
from test_torch_convert import jax_to_numpy
import torch_train_worker

torch.set_num_threads(2)

# JAX's sharded-step test model (tests/test_sharded_step.py)
CFG = dict(arch="llama", vocab_size=512, hidden_size=256, intermediate_size=512,
           num_layers=2, num_heads=4, num_kv_heads=4)
LCFG = dict(r=4, alpha=8)
LOSS_RTOL, GNORM_RTOL = 2e-3, 5e-3
MESHES = [(2, 1, 2), (1, 2, 2)]
STEPS, LR = 3, 1e-3


def _problem():
    """Dense and NF4 JAX params, a LoRA with nonzero B, a batch of 8 x 16."""
    jcfg = JModelConfig(**CFG)
    dense = jinit_params(jax.random.PRNGKey(0), jcfg, quantized=False)
    nf4 = jinit_params(jax.random.PRNGKey(0), jcfg, quantized=True)
    lora = jinit_lora(jax.random.PRNGKey(1), jcfg, JLoraConfig(**LCFG))
    rng = np.random.default_rng(1)
    lora = {n: {"a": ad["a"], "b": jnp.asarray(rng.normal(size=ad["b"].shape) * 0.05,
                                               jnp.float32)} for n, ad in lora.items()}
    ids = np.random.default_rng(2).integers(0, CFG["vocab_size"], (8, 16)).astype(np.int32)
    batch = {"input_ids": ids, "attention_mask": np.ones_like(ids), "labels": ids}
    return jcfg, dense, nf4, lora, batch


def _stacked(batch, accum):
    return batch if accum == 1 else {k: v.reshape(accum, -1, v.shape[-1]) for k, v in batch.items()}


def _jax_run(step, state, params, batch, steps):
    out = {"loss": [], "grad_norm": []}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for i in range(steps):
        state, m = step(state, params, jb, jax.random.PRNGKey(50 + i))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    return out, state


def _port_leaves(jtree):
    """A JAX params tree's leaves in the port's order (per layer)."""
    return [t.float().numpy() for t in
            tree_leaves(params_from_numpy(jax_to_numpy(jtree), ModelConfig(**CFG), "cpu"))]


@pytest.fixture(scope="module")
def world():
    """Every case in one world of 4 ranks; what JAX computes on the same inputs."""
    jcfg, dense, nf4, lora, batch = _problem()
    cfg = ModelConfig(**CFG)
    jl = JLoraConfig(**LCFG)
    common = dict(cfg=cfg, lcfg_kw=LCFG, batch=batch)
    dense_np, nf4_np, lora_np = jax_to_numpy(dense), jax_to_numpy(nf4), jax_to_numpy(lora)
    cases, ref = [], {}
    opt = jmake_optimizer("paged_adamw_32bit", LR, total_steps=10)
    for shape in MESHES:
        cases.append((f"full{shape}", "gspmd", dict(common, params_np=dense_np, lora_np=None,
                                                    shape=shape, lr=LR)))
        cases.append((f"lora{shape}", "gspmd", dict(common, params_np=nf4_np, lora_np=lora_np,
                                                    shape=shape, mode="lora", lr=LR)))
    cases.append(("full-accum", "gspmd", dict(common, params_np=dense_np, lora_np=None,
                                              shape=(1, 2, 2), lr=LR, accum=2, steps=2,
                                              batch=_stacked(batch, 2))))
    cases.append(("sgd", "gspmd", dict(common, params_np=dense_np, lora_np=None,
                                       shape=(1, 2, 2), opt="sgd", lr=1.0, clip_norm=None,
                                       steps=1)))
    with tempfile.TemporaryDirectory() as store:
        out = run_ranks(torch_train_worker.world, 4, cases, backend="gloo",
                        devices=["cpu"] * 4, store_dir=store, timeout_s=600)
    ref["full"], _ = _jax_run(jmake_train_step(jcfg, jl, opt, donate=False, mode="full"),
                              jinit_train_state(dense, opt), None, batch, STEPS)
    ref["full-accum"], _ = _jax_run(
        jmake_train_step(jcfg, jl, opt, accum_steps=2, donate=False, mode="full"),
        jinit_train_state(dense, opt), None, _stacked(batch, 2), 2)
    ref["lora"], s_end = _jax_run(jmake_train_step(jcfg, jl, opt, donate=False),
                                  jinit_train_state(lora, opt), nf4, batch, STEPS)
    ref["lora_end"] = jax_to_numpy(s_end.trainable)
    # JAX's gradients of the batch's mean loss (mode "full", remat "full")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    ref["grads"] = jax.grad(
        lambda t: jloss_fn(t, None, jbatch, jcfg, None, None, True, "full", "full")[0])(dense)
    ref["dense"] = dense
    return out, ref


def _close(got, want, tag):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL, err_msg=tag)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=GNORM_RTOL, err_msg=tag)


@pytest.mark.parametrize("mode", ["full", "lora"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_gspmd_step_matches_jax_single_device(world, shape, mode):
    """3 steps: each step's loss and grad norm against JAX's single-device
    step (mode "full": the dense model, remat "full"; "lora": NF4), the same
    numbers on every rank; in mode "lora" the adapters after 3 steps within
    the sharded steps' tail bounds of JAX's."""
    out, ref = world
    ranks = [o[f"{mode}{shape}"] for o in out]
    _close(ranks[0], ref[mode], f"{mode} {shape}")
    assert all(r["loss"] == ranks[0]["loss"] and r["grad_norm"] == ranks[0]["grad_norm"]
               for r in ranks)
    if mode == "lora":
        want = [np.asarray(ref["lora_end"][n][k])[i] for i in range(CFG["num_layers"])
                for n in ref["lora_end"] for k in ("a", "b")]
        got = ranks[0]["whole"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            d = np.abs(g - w)
            assert d.max() < 8e-3 and d.mean() < 2e-4, (d.max(), d.mean())


def test_gspmd_accumulation_matches_jax(world):
    """2 micro-batches a step at (1, 2, 2) against JAX's accumulating step."""
    out, ref = world
    _close(out[0]["full-accum"], ref["full-accum"], "accum")


def test_gspmd_gradients_and_first_update(world):
    """At (1, 2, 2), the gradients the optimizer gets from an SGD(1.0) step
    without a clip, gathered from the ranks' slices: each tensor's within
    5 % of its norm of JAX's.  The AdamW update of the same mesh's second
    step (the warmup's first moves nothing; both steps see the same
    parameters, so the same gradients), gathered, against optax's AdamW
    (JAX's ``paged_adamw_32bit``, its clip included) given those gradients
    twice in the parameters' dtypes, as JAX's step hands them over: within
    2 % of its norm (bf16 moments against f32: C7)."""
    out, ref = world
    grads = _gathered([o["sgd"] for o in out], "grads")
    want = _port_leaves(ref["grads"])
    assert len(grads) == len(want) == 2 + 9 * CFG["num_layers"] + 1
    for i, (g, w) in enumerate(zip(grads, want)):
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err < 0.05, (i, float(err))
    jgrads = jax.tree_util.tree_map(lambda g, p: jnp.asarray(g, p.dtype),
                                    _to_jax_tree(grads, ref["dense"]), ref["dense"])
    jopt = jmake_optimizer("paged_adamw_32bit", LR, total_steps=10)
    _, jstate = jopt.update(jgrads, jopt.init(ref["dense"]), ref["dense"])   # lr 0 at count 0
    jup, _ = jopt.update(jgrads, jstate, ref["dense"])
    got = _gathered([o["full(1, 2, 2)"] for o in out], "update")
    for i, (u, w) in enumerate(zip(got, _port_leaves(jup))):
        err = np.linalg.norm(u - w) / np.linalg.norm(w)
        assert err < 0.02, (i, float(err))


def _gathered(ranks, key):
    """Each tensor of ``ranks[r][key]`` whole: the slices of the ranks at
    d = 0 put together in shard order (f·T + t) along the tensor's split
    dimension, or rank 0's where the tensor is whole."""
    at = {r["coords"]: r for r in ranks}
    F = 1 + max(f for f, _ in at)
    T = 1 + max(t for _, t in at)
    out = []
    for i, dim in enumerate(ranks[0]["dims"]):
        if dim is None:
            out.append(at[(0, 0)][key][i])
        else:
            out.append(np.concatenate([at[(f, t)][key][i] for f in range(F) for t in range(T)],
                                      axis=dim))
    return out


def _to_jax_tree(leaves, jtree):
    """The port's per-layer leaves (numpy) as a JAX params tree shaped as
    `jtree` (LLaMA, no biases): the blocks' tensors stacked over layers."""
    from qlora_tpu_torch.train.optimizer import tree_unflatten

    cfg = ModelConfig(**CFG)
    tree = tree_unflatten(params_from_numpy(jax_to_numpy(jtree), cfg, "cpu"),
                          [torch.from_numpy(x) for x in leaves])
    layers = lambda get: np.stack([get(b) for b in tree["blocks"]])

    def rebuild(j, path):
        if isinstance(j, dict):
            return {k: rebuild(v, path + (k,)) for k, v in j.items()}
        if path[0] == "blocks":
            name = path[1]
            if hasattr(j, "w"):
                return type(j)(w=layers(lambda b: b[name].w.numpy()), bias=None)
            return layers(lambda b: b[name].numpy())
        if path[0] == "lm_head":
            return type(j)(w=tree["lm_head"].w.numpy(), bias=None)
        if path[0] == "embed":
            return tree["embed"].numpy()
        return tree["final_norm"][path[1]].numpy()

    return rebuild(jtree, ())


@pytest.mark.parametrize("case", ["full(2, 1, 2)", "full(1, 2, 2)", "lora(1, 2, 2)"])
def test_gspmd_replicas_bit_equal_and_shards_shrink(world, case):
    """After 3 steps every rank's copy of a whole tensor has the same bits,
    and each shard the same bits as on its dp replicas; a rank's trainable
    model and its moments are ~1/(fsdp·tp) of the whole (mode "full"),
    the adapters whole (mode "lora")."""
    out, _ = world
    ranks = [o[case] for o in out]
    by_coords = {}
    for r in ranks:
        by_coords.setdefault(r["coords"], []).append(r["digests"])
    for copies in by_coords.values():
        assert all(c == copies[0] for c in copies)
    n_model = len(by_coords)
    if case.startswith("lora"):
        assert all(r["digests"] == ranks[0]["digests"] for r in ranks)
        return
    whole = [j for j in range(len(ranks[0]["digests"]))
             if len({r["digests"][j] for r in ranks}) == 1]
    assert len(whole) == 2 * CFG["num_layers"] + 1          # the norms only
    for r in ranks:
        share = r["trainable_bytes"] / r["whole_bytes"]
        assert 1 / n_model <= share < 1.01 / n_model, share
        assert r["opt_bytes"] == 8 * r["trainable_numel"]      # f32 mu and nu
