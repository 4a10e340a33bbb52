"""The port's training step against the JAX package's: loss, schedule, both
optimizers against the optax chains, N-step trajectories of
``make_train_step`` from one adapter carried into both trainers, the remat
policies (``"save_linear"``, the default, against ``"full"``, no remat and
JAX's), and full finetuning (``mode="full"``) of the unquantized model.

Everything random is made with numpy from a seed; JAX parameters are carried
across byte for byte.  The model is ``debug`` (LLaMA, 2 layers, hidden 256,
head_dim 64) at S = 128, where both packages take their flash attention
(JAX: the Pallas kernels in interpret mode).  Tolerances are stated at each
test."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qlora_tpu.models import get_config as jget_config
from qlora_tpu.models import init_params as jinit_params
from qlora_tpu.train import init_train_state as jinit_train_state
from qlora_tpu.train import make_optimizer as jmake_optimizer
from qlora_tpu.train import make_train_step as jmake_train_step
from qlora_tpu.train import masked_cross_entropy as jmasked_cross_entropy
from qlora_tpu.train import warmup_constant_schedule as jschedule
from qlora_tpu.train.optimizer import _dq8 as jdq8

from qlora_tpu_torch.lora import LoraConfig
from qlora_tpu_torch.models import get_config
from qlora_tpu_torch.train import (
    IGNORE_INDEX, TrainState, apply_updates, global_norm, init_train_state, loss_fn,
    make_eval_step, make_optimizer, make_train_step, masked_cross_entropy,
    warmup_constant_schedule,
)
from qlora_tpu_torch.train.optimizer import _dq8, tree_leaves, tree_map, tree_unflatten
from qlora_tpu_torch.utils import lora_to_numpy
from chip_smoke import frozen_tensors
from test_torch_convert import bridge, jax_to_numpy, nonzero_lora

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# loss and schedule
# ---------------------------------------------------------------------------


def test_masked_cross_entropy_matches_jax():
    """f32 on both sides: rtol 1e-5."""
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 17, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, size=(3, 17)).astype(np.int32)
    labels[0, :9] = IGNORE_INDEX
    labels[2] = IGNORE_INDEX
    want, wn = jmasked_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got, n = masked_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    assert int(n) == int(wn) == 17 * 3 - 9 - 17
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    # bf16 logits are computed in f32 too
    got16, _ = masked_cross_entropy(torch.from_numpy(logits).to(torch.bfloat16),
                                    torch.from_numpy(labels))
    want16, _ = jmasked_cross_entropy(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(labels))
    np.testing.assert_allclose(float(got16), float(want16), rtol=1e-5)


def test_masked_cross_entropy_all_ignored_is_finite():
    loss, n = masked_cross_entropy(torch.zeros(1, 3, 8), torch.full((1, 3), IGNORE_INDEX))
    assert int(n) == 0 and float(loss) == 0.0
    loss, n = masked_cross_entropy(torch.zeros(1, 4, 8),
                                   torch.tensor([[1, IGNORE_INDEX, 2, IGNORE_INDEX]]))
    assert int(n) == 2
    np.testing.assert_allclose(float(loss), np.log(8), rtol=1e-6)


@pytest.mark.parametrize("total,ratio", [(100, 0.03), (10, 0.03), (200, 0.1)])
def test_schedule_matches_optax(total, ratio):
    """The first value is 0 (optax reads the count before its increment);
    f32 against a Python float: rtol 1e-6."""
    js, ts = jschedule(2e-4, total, ratio), warmup_constant_schedule(2e-4, total, ratio)
    assert ts(0) == 0.0 == float(js(0))
    for count in range(0, 40):
        np.testing.assert_allclose(ts(count), float(js(count)), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# optimizers against the optax chains, on fixed gradients
# ---------------------------------------------------------------------------


def _fixed_problem(steps=6):
    """A small tree with a leaf that no block of 256 divides, and gradients
    whose norm is above the clip of 0.3 on some steps and below it on others."""
    rng = np.random.default_rng(1)
    shapes = {"a": (40, 8), "b": (8, 33), "c": (700,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = []
    for i in range(steps):
        scale = 0.5 if i % 2 == 0 else 0.002
        grads.append({k: (rng.normal(size=s) * scale).astype(np.float32)
                      for k, s in shapes.items()})
    return params, grads


def _run_both(name, steps=6, offload=False, **kw):
    params, grads = _fixed_problem(steps)
    jopt = jmake_optimizer(name, 1e-2, total_steps=100, **kw)
    topt = make_optimizer(name, 1e-2, total_steps=100, offload_state=offload, **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jstate, tstate = jopt.init(jp), topt.init(tp)
    out = []
    for g in grads:
        ju, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        tu, tstate = topt.update({k: torch.from_numpy(v) for k, v in g.items()}, tstate, tp)
        jp, tp = optax.apply_updates(jp, ju), apply_updates(tp, tu)
        out.append((ju, tu))
    return out, (jp, tp), (jstate, tstate)


@pytest.mark.parametrize("kw", [{}, {"weight_decay": 0.1, "b2": 0.95}])
def test_adamw_matches_optax_chain(kw):
    """f32 elementwise arithmetic in another association: rtol 2e-5 of each
    update, atol 1e-9; the parameters after 6 such updates of about the
    learning rate (1e-2) within 6 * 2e-5 * 1e-2 ~ 1e-6."""
    steps, (jp, tp), _ = _run_both("paged_adamw_32bit", **kw)
    for k in steps[0][1]:
        assert (steps[0][1][k] == 0).all()          # the first learning rate is 0
    for ju, tu in steps:
        for k in tu:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]), rtol=2e-5, atol=1e-9)
    assert any((tu["a"] != 0).any() for _, tu in steps[1:])
    for k in tp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kw", [{}, {"weight_decay": 0.1}])
def test_adam8bit_matches_jax(kw):
    """The int8 codes may land one apart where f32 rounding differs (one
    code is 1/127 of its block's largest value): the dequantized states
    within 1.01 codes, the updates within 2 % of the learning rate's size."""
    steps, (jp, tp), (jstate, tstate) = _run_both("adam8bit", **kw)
    assert all((tu[k] == 0).all() for k in steps[0][1] for _, tu in steps[:1])
    lr = 1e-2
    for i, (ju, tu) in enumerate(steps):
        for k in tu:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]), rtol=0,
                                       atol=0.02 * lr + 1e-9, err_msg=f"step {i} leaf {k}")
    assert tstate["count"] == int(jstate.count) == len(steps)
    for i, k in enumerate(("a", "b", "c")):            # both flatten the dict in this order
        for tq, ts, jq, js in ((tstate["m_q"][i], tstate["m_s"][i], jstate.m_q[k], jstate.m_s[k]),
                               (tstate["sv_q"][i], tstate["sv_s"][i], jstate.sv_q[k],
                                jstate.sv_s[k])):
            assert tq.dtype == torch.int8 and tq.numel() == jq.size
            np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4, atol=1e-12)
            code = np.repeat(np.asarray(js) / 127.0, 256)[: jq.size]
            assert (np.abs(_dq8(tq, ts).numpy() - np.asarray(jdq8(jq, js))) <= 1.01 * code
                    + 1e-12).all()


@pytest.mark.parametrize("name", ["paged_adamw_32bit", "adam8bit"])
def test_host_offload_keeps_the_updates(name):
    """Resting the state in host memory between steps changes no number."""
    plain, (_, tp0), _ = _run_both(name)
    paged, (_, tp1), (_, state) = _run_both(name, offload=True)
    for (_, a), (_, b) in zip(plain, paged):
        for k in a:
            assert torch.equal(a[k], b[k])
    assert all(torch.equal(tp0[k], tp1[k]) for k in tp0)
    assert all(t.device.type == "cpu" for t in tree_leaves(state))


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("sgd", 1e-3, 10)


# ---------------------------------------------------------------------------
# the train step against JAX's
# ---------------------------------------------------------------------------


def _batch(cfg, seed, bs=2, S=128):
    """Right-padded rows with -100 on a source prefix and on the padding,
    as the collator gives them."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, cfg.vocab_size, size=(bs, S)).astype(np.int32)
    mask = np.ones((bs, S), np.int32)
    labels = ids.copy()
    for b in range(bs):
        n = int(rng.integers(S // 2, S + 1)) if b else S
        mask[b, n:] = 0
        ids[b, n:] = 0
        labels[b, n:] = IGNORE_INDEX
        labels[b, : int(rng.integers(4, S // 4))] = IGNORE_INDEX
    return {"input_ids": ids, "attention_mask": mask, "labels": labels}


@pytest.fixture(scope="module")
def model():
    jcfg = jget_config("debug")
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
    jlora, jlcfg = nonzero_lora(jcfg)
    cfg = get_config("debug")
    params, lora = bridge(jparams, jlora, cfg)
    return (jcfg, jparams, jlora, jlcfg), (cfg, params, lora, LoraConfig(r=jlcfg.r,
                                                                        alpha=jlcfg.alpha))


def _delta_error(final, start, jfinal, jstart):
    """‖Δport − ΔJAX‖ / ‖ΔJAX‖ over the whole adapter, Δ = final − start."""
    num = den = 0.0
    for name in jfinal:
        for k in ("a", "b"):
            dj = np.asarray(jfinal[name][k]) - np.asarray(jstart[name][k])
            dt = final[name][k] - start[name][k]
            num += float(((dt - dj) ** 2).sum())
            den += float((dj ** 2).sum())
    return (num / den) ** 0.5


@pytest.mark.parametrize("accum", [1, 2])
def test_trajectory_matches_jax(model, accum):
    """5 optimizer steps from one adapter, with and without accumulation.

    Both sides compute bf16 activations with f32 sums in other orders, so a
    gradient differs by bf16 noise; Adam then normalises each element's
    update to about the learning rate, which turns noise in the smallest
    gradients into whole steps.  So: losses and gradient norms within 1 %,
    the first step moves nothing on either side (learning rate 0), and the
    adapters' total movement agrees to 15 % of its norm."""
    (jcfg, jp, jl, jlc), (cfg, p, lo, lc) = model
    steps, lr = 5, 5e-3
    mbs = [_batch(cfg, seed) for seed in range(accum)]
    batch = mbs[0] if accum == 1 else {k: np.stack([m[k] for m in mbs]) for k in mbs[0]}
    jopt = jmake_optimizer("paged_adamw_32bit", lr, total_steps=steps)
    jstep = jmake_train_step(jcfg, jlc, jopt, accum_steps=accum, donate=False)
    jstate = jinit_train_state(jl, jopt)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    topt = make_optimizer("paged_adamw_32bit", lr, total_steps=steps)
    tstep = make_train_step(cfg, lc, topt, accum_steps=accum, device="cpu")
    tstate = init_train_state(lo, topt, device="cpu")
    start = lora_to_numpy(tstate.trainable)
    jm, tm = [], []
    for i in range(steps):
        jstate, m = jstep(jstate, jp, jbatch, jax.random.PRNGKey(i))
        jm.append((float(m["loss"]), float(m["grad_norm"])))
        tstate, m = tstep(tstate, p, batch)
        tm.append((float(m["loss"]), float(m["grad_norm"])))
        if i == 0:
            after_first = lora_to_numpy(tstate.trainable)
            assert all(np.array_equal(after_first[n][k], start[n][k])
                       for n in start for k in "ab")
    np.testing.assert_allclose(np.array(tm), np.array(jm), rtol=1e-2)
    assert tm[-1][0] < tm[0][0] and tstate.step == steps == int(jstate.step)
    err = _delta_error(lora_to_numpy(tstate.trainable), start, jstate.trainable, jl)
    assert err < 0.15, err


def test_accumulation_equivalence(model):
    """Two identical micro-batches accumulate to the single batch's step:
    the same gradients twice, summed and halved in f32 (loss rtol 1e-6,
    adapters atol 1e-6)."""
    _, (cfg, p, lo, lc) = model
    opt = make_optimizer("paged_adamw_32bit", 1e-3, total_steps=3)
    mb = _batch(cfg, 5)
    s1 = init_train_state(lo, opt, device="cpu")
    s2 = init_train_state(lo, opt, device="cpu")
    step1 = make_train_step(cfg, lc, opt, accum_steps=1, device="cpu")
    step2 = make_train_step(cfg, lc, opt, accum_steps=2, device="cpu")
    stacked = {k: np.stack([v, v]) for k, v in mb.items()}
    for _ in range(2):                       # the second step has a nonzero learning rate
        s1, m1 = step1(s1, p, mb)
        s2, m2 = step2(s2, p, stacked)
        np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-6)
        np.testing.assert_allclose(float(m1["grad_norm"]), float(m2["grad_norm"]), rtol=1e-6)
    for a, b in zip(tree_leaves(s1.trainable), tree_leaves(s2.trainable)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(s1.trainable),
                                                     tree_leaves(lo)))


@pytest.fixture(scope="module")
def model8():
    """The debug model with an int8 base (``--bits 8``: blockwise int8 codes,
    double-quantized absmax), made by JAX and carried across."""
    jcfg = jget_config("debug")
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg, quant_type="int8")
    jlora, jlcfg = nonzero_lora(jcfg)
    cfg = get_config("debug")
    params, lora = bridge(jparams, jlora, cfg)
    assert params["blocks"][0]["wq"].qt.packed.dtype == torch.int8
    return (jcfg, jparams, jlora, jlcfg), (cfg, params, lora, LoraConfig(r=jlcfg.r,
                                                                        alpha=jlcfg.alpha))


def test_int8_base_loss_and_gradients_match_jax(model8):
    """One micro-batch through both ``loss_fn``s over an int8 base (JAX: the
    int8 Pallas kernels, forward and dx, in interpret mode).  bf16
    activations with f32 sums in other orders, as the NF4 case: the loss
    within 1 %, every LoRA gradient within 5 % of its norm."""
    from qlora_tpu.train.step import loss_fn as jloss_fn

    (jcfg, jp, jl, jlc), (cfg, p, lo, lc) = model8
    batch = _batch(cfg, 3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda t: jloss_fn(t, jp, jbatch, jcfg, jlc, None, True, "lora", "full"),
        has_aux=True)(jl)
    leaves = [t.detach().clone().requires_grad_() for t in tree_leaves(lo)]
    it = iter(leaves)
    lora = tree_map(lambda _: next(it), lo)
    loss, n = loss_fn(lora, p, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg, lc,
                      None, True, "lora", "full")
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-2)
    it = iter(grads)
    got = lora_to_numpy(tree_map(lambda _: next(it), lo))
    for name in jgrads:
        for k in ("a", "b"):
            want = np.asarray(jgrads[name][k])
            for layer in range(cfg.num_layers):
                err = np.linalg.norm(got[name][k][layer] - want[layer]) / np.linalg.norm(
                    want[layer])
                assert err < 0.05, (name, k, layer, err)


def test_int8_base_trains_and_stays_frozen(model8):
    """5 optimizer steps over the int8 base: the first moves nothing, the
    loss then falls, and no int8 code, absmax or scale changes."""
    _, (cfg, p, lo, lc) = model8
    before = _snapshot(p)
    opt = make_optimizer("paged_adamw_32bit", 5e-3, total_steps=5)
    state = init_train_state(lo, opt, device="cpu")
    step = make_train_step(cfg, lc, opt, device="cpu")
    batch = _batch(cfg, 7)
    losses = []
    for _ in range(5):
        state, m = step(state, p, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[1] == losses[0]
    assert losses[-1] < losses[0] * 0.98, losses
    assert all(torch.equal(a, b) for a, b in zip(before, _snapshot(p)))


def test_merge_lora_into_int8_params_requantizes_int8(model8):
    """``merge_lora_into_params`` keeps the storage it finds: an int8 base
    comes back int8, with the adapter folded in."""
    from qlora_tpu_torch.lora import merge_lora_into_params
    from qlora_tpu_torch.quant import dequantize

    _, (cfg, p, lo, lc) = model8
    merged = merge_lora_into_params(p, lo, lc)
    qt, old = merged["blocks"][0]["wq"].qt, p["blocks"][0]["wq"].qt
    assert qt.quant_type == "int8" and qt.packed.dtype == torch.int8 and qt.double_quant
    want = dequantize(old, torch.float32) + lc.scale * (lo[0]["wq"]["a"] @ lo[0]["wq"]["b"])
    err = (dequantize(qt, torch.float32) - want).abs().max()
    assert err <= want.abs().max() / 127 * 0.51 + 1e-3       # half an int8 step (+ absmax codes)


def _snapshot(params):
    """A copy of every tensor in a params tree, dataclasses included."""
    return [t.clone() for t in frozen_tensors(params)]


@pytest.mark.parametrize("opt_name", ["paged_adamw_32bit", "adam8bit"])
def test_frozen_parameters_unchanged_and_loss_falls(model, opt_name):
    _, (cfg, p, lo, lc) = model
    before = _snapshot(p)
    assert all(not t.requires_grad for t in before)
    opt = make_optimizer(opt_name, 5e-3, total_steps=30)
    state = init_train_state(lo, opt, device="cpu")
    step = make_train_step(cfg, lc, opt, device="cpu")
    batch = _batch(cfg, 7)
    losses = []
    for _ in range(6):
        state, m = step(state, p, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0] * 0.98, losses
    after = _snapshot(p)
    assert len(after) == len(before) > 20
    assert all(torch.equal(a, b) and not b.requires_grad for a, b in zip(before, after))
    # the adapter handed in is not written to either
    assert all(not t.requires_grad for t in tree_leaves(lo))


def _grads(model, remat, dropout=0.0, seed=None):
    _, (cfg, p, lo, lc) = model
    lc = dataclasses.replace(lc, dropout=dropout)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 11).items()}
    leaves = [t.detach().clone().requires_grad_() for t in tree_leaves(lo)]
    it = iter(leaves)
    lora = tree_map(lambda _: next(it), lo)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    loss, n = loss_fn(lora, p, batch, cfg, lc, gen, True, "lora", remat)
    return float(loss.detach()), torch.autograd.grad(loss, leaves)


def test_remat_full_gives_the_gradients_of_no_remat(model):
    """The recomputed forward is the same arithmetic: equal to f32 noise
    (rtol 1e-5); with dropout the recomputation draws the same masks."""
    for dropout, seed in ((0.0, None), (0.1, 3)):
        l0, g0 = _grads(model, False, dropout, seed)
        l1, g1 = _grads(model, "full", dropout, seed)
        assert l0 == l1
        for a, b in zip(g0, g1):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-8)
    l2, g2 = _grads(model, "full", 0.1, 4)            # another seed, other masks
    assert l2 != l1 and any(not torch.equal(a, b) for a, b in zip(g1, g2))


def test_what_is_left_out_raises_with_its_roadmap_item(model):
    """Nothing of ROADMAP item A2 is left out any more: ``remat="save_linear"``
    (now the default) and ``mode="full"`` build and run; what still raises is
    a mode or policy that does not exist, and an entry point asked for the
    card where there is none."""
    _, (cfg, p, lo, lc) = model
    opt = make_optimizer("adamw", 1e-3, 10)
    state, m = make_train_step(cfg, lc, opt, remat="save_linear", device="cpu")(
        init_train_state(lo, opt, device="cpu"), p, _batch(cfg, 0))
    assert state.step == 1 and np.isfinite(float(m["loss"]))
    make_train_step(cfg, lc, opt, mode="full", device="cpu")
    with pytest.raises(ValueError, match="mode must be"):
        make_train_step(cfg, lc, opt, mode="qlora", device="cpu")
    with pytest.raises(ValueError, match="remat must be"):
        make_train_step(cfg, lc, opt, remat="save_all", device="cpu")(
            init_train_state(lo, opt, device="cpu"), p, _batch(cfg, 0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(cfg, lc, opt)               # the card unless the caller names the CPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(lo, opt)


def test_eval_step_matches_jax(model):
    """No dropout, no gradient: the loss of the JAX eval step within 1 %."""
    from qlora_tpu.train import make_eval_step as jmake_eval_step

    (jcfg, jp, jl, jlc), (cfg, p, lo, lc) = model
    batch = _batch(cfg, 13)
    want, wn = jmake_eval_step(jcfg, jlc)(jl, jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got, n = make_eval_step(cfg, lc, device="cpu")(lo, p, batch)
    assert int(n) == int(wn) and not got.requires_grad
    np.testing.assert_allclose(float(got), float(want), rtol=1e-2)
    assert isinstance(init_train_state(lo, make_optimizer("adamw", 1e-3, 10), device="cpu"),
                      TrainState)
    assert float(global_norm(lo)) > 0


# ---------------------------------------------------------------------------
# remat="save_linear"
# ---------------------------------------------------------------------------


def test_save_linear_gives_the_gradients_of_full_no_remat_and_jax(model):
    """``"save_linear"`` replays the kept matmul and attention outputs, which
    are the bits a recomputation would give: its loss and every gradient
    equal ``"full"``'s and no remat's exactly, with dropout too (the same
    masks are drawn again).  Against JAX's ``loss_fn`` under its default
    ``"save_linear"`` policy (the Pallas kernels in interpret mode), as the
    int8 case: the loss within 1 %, every LoRA gradient within 5 % of its
    norm."""
    from qlora_tpu.train.step import loss_fn as jloss_fn

    for dropout, seed in ((0.0, None), (0.1, 3)):
        l0, g0 = _grads(model, False, dropout, seed)
        for remat in ("full", "save_linear"):
            l1, g1 = _grads(model, remat, dropout, seed)
            assert l1 == l0
            assert all(torch.equal(a, b) for a, b in zip(g0, g1)), remat
    (jcfg, jp, jl, jlc), (cfg, p, lo, lc) = model
    batch = _batch(cfg, 11)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda t: jloss_fn(t, jp, jbatch, jcfg, jlc, None, True, "lora", "save_linear"),
        has_aux=True)(jl)
    loss, grads = _grads(model, "save_linear")
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-2)
    it = iter(grads)
    got = lora_to_numpy(tree_map(lambda _: next(it), lo))
    for name in jgrads:
        for k in ("a", "b"):
            want = np.asarray(jgrads[name][k])
            for layer in range(cfg.num_layers):
                err = np.linalg.norm(got[name][k][layer] - want[layer]) / np.linalg.norm(
                    want[layer])
                assert err < 0.05, (name, k, layer, err)


def _counted(monkeypatch):
    """Count the plain NF4 forward and flash forward (the CPU's versions of
    the kernels) as the model calls them."""
    qm = importlib.import_module("qlora_tpu_torch.ops.qmatmul")
    fa = importlib.import_module("qlora_tpu_torch.ops.flash_attention")
    calls = {"qmm": 0, "flash": 0}

    def wrap(mod, name, key):
        fn = getattr(mod, name)

        def counted(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)

    wrap(qm, "qmatmul_plain", "qmm")
    wrap(fa, "flash_fwd_plain", "flash")
    return calls


@pytest.mark.parametrize("remat,per_layer", [("save_linear", 1), ("full", 2), (False, 1)])
def test_save_linear_runs_each_forward_kernel_once(model, monkeypatch, remat, per_layer):
    """A micro-batch runs the NF4 forward 7 L times and flash forward L times
    under ``"save_linear"`` (the backward's recomputed blocks read them back),
    14 L and 2 L under ``"full"`` (each block's forward runs again), 7 L and L
    without remat: over a train step of 2 micro-batches, twice that."""
    _, (cfg, p, lo, lc) = model
    calls = _counted(monkeypatch)
    opt = make_optimizer("paged_adamw_32bit", 1e-3, total_steps=3)
    step = make_train_step(cfg, lc, opt, accum_steps=2, remat=remat, device="cpu")
    mb = _batch(cfg, 5)
    step(init_train_state(lo, opt, device="cpu"), p, {k: np.stack([v, v]) for k, v in mb.items()})
    L = cfg.num_layers
    assert calls == {"qmm": 2 * 7 * L * per_layer, "flash": 2 * L * per_layer}


# ---------------------------------------------------------------------------
# mode="full": full finetuning of the unquantized model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dense_model():
    """The debug model unquantized (bf16 dense linears), made by JAX and
    carried across."""
    jcfg = jget_config("debug")
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg, quantized=False)
    cfg = get_config("debug")
    params, _ = bridge(jparams, None, cfg)
    return (jcfg, jparams), (cfg, params)


def test_full_finetune_loss_grads_and_update_match_jax(dense_model):
    """``mode="full"``: one micro-batch through both ``loss_fn``s (JAX: its
    flash kernels in interpret mode, remat "full") and one AdamW update of
    every tensor (embedding, norms, each dense linear, lm_head).  bf16
    activations with f32 sums in other orders, as the LoRA case: the loss
    within 1 %, every gradient within 5 % of its norm.  The update, both
    optimizers on JAX's gradients: optax's AdamW keeps the moments in the
    parameters' dtype (bf16 for the weights), the port's ``paged_adamw_32bit``
    in f32 (as its name says), so each update lies within 2 % of its norm of
    JAX's (bf16 rounding of the moments), and the parameters after it within
    1e-3 of theirs."""
    from qlora_tpu.train.optimizer import adamw as jadamw
    from qlora_tpu.train.step import loss_fn as jloss_fn
    from qlora_tpu_torch.train.optimizer import adamw
    from qlora_tpu_torch.utils.convert import params_from_numpy

    (jcfg, jp), (cfg, p) = dense_model
    batch = _batch(cfg, 17)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda t: jloss_fn(t, None, jbatch, jcfg, None, None, True, "full", "full"),
        has_aux=True)(jp)
    leaves = [t.detach().clone().requires_grad_() for t in tree_leaves(p)]
    loss, n = loss_fn(tree_unflatten(p, leaves), None, {k: torch.from_numpy(v) for k, v in batch.items()},
                      cfg, LoraConfig(), None, True, "full", "full")
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-2)
    want = tree_leaves(params_from_numpy(jax_to_numpy(jgrads), cfg, "cpu"))
    assert len(want) == len(grads) == 2 + 9 * cfg.num_layers + 1
    for i, (g, w) in enumerate(zip(grads, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, i
        err = (g.float() - w.float()).norm() / w.float().norm()
        assert err < 0.05, (i, tuple(g.shape), float(err))

    # one AdamW update of both optimizers on the same (JAX's) gradients
    lr = 1e-3
    jopt, topt = jadamw(lr), adamw(lr)
    jup, _ = jopt.update(jgrads, jopt.init(jp), jp)
    tup, _ = topt.update(tree_unflatten(p, want), topt.init(p), p)
    jnew = tree_leaves(params_from_numpy(jax_to_numpy(optax.apply_updates(jp, jup)), cfg, "cpu"))
    jup = tree_leaves(params_from_numpy(jax_to_numpy(jup), cfg, "cpu"))
    for i, (u, w, new, got) in enumerate(zip(tree_leaves(tup), jup, jnew,
                                              tree_leaves(apply_updates(p, tup)))):
        err = (u.float() - w.float()).norm() / w.float().norm()
        assert err < 0.02, (i, float(err))
        assert got.dtype == new.dtype
        assert (got.float() - new.float()).norm() <= 1e-3 * new.float().norm(), i


def test_full_finetune_trains_every_tensor_and_forces_full_remat(dense_model, monkeypatch):
    """3 steps of ``mode="full"`` with 2 micro-batches: the first moves
    nothing (learning rate 0), the loss then falls, every tensor of the model
    has moved, the parameters handed in are not written to; remat
    "save_linear" (the default) runs "full" here, as JAX's step does: each
    block's flash forward twice a micro-batch.  The eval step takes the same
    tree."""
    _, (cfg, p) = dense_model
    before = [t.clone() for t in tree_leaves(p)]
    calls = _counted(monkeypatch)
    opt = make_optimizer("paged_adamw_32bit", 2e-3, total_steps=3)
    state = init_train_state(p, opt, device="cpu")
    step = make_train_step(cfg, LoraConfig(), opt, accum_steps=2, mode="full", device="cpu")
    mbs = [_batch(cfg, s) for s in (21, 22)]
    batch = {k: np.stack([m[k] for m in mbs]) for k in mbs[0]}
    losses = []
    for _ in range(3):
        state, m = step(state, None, batch)
        losses.append(float(m["loss"]))
    L = cfg.num_layers
    assert calls == {"qmm": 0, "flash": 3 * 2 * 2 * L}
    assert losses[1] == losses[0] and losses[2] < losses[0], losses
    after = tree_leaves(state.trainable)
    assert len(after) == len(before) == 2 + 9 * L + 1
    assert all(not torch.equal(a, b) for a, b in zip(after, before))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p), before))
    got, n = make_eval_step(cfg, LoraConfig(), mode="full", device="cpu")(
        state.trainable, None, mbs[0])
    assert int(n) > 0 and float(got) < losses[0]
