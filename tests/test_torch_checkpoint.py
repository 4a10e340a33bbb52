"""Checkpoints and the quantized store, written by one package and read by
the other, in both directions (``qlora_tpu_torch/utils/checkpoint.py``,
``utils/quantized_store.py`` against ``qlora_tpu/utils/...``).

Everything is made from seeds; JAX trees are carried into the port's layout
byte for byte (``test_torch_convert.bridge``).  What is read back is held
bit for bit.  The next optimizer step after a load is held to the same
tolerance as the optimizer parity tests of ``test_torch_train.py``: AdamW
rtol 2e-5 of each update (f32 in another association), adam8bit atol 2 %
of the learning rate (an int8 code may land one apart); ``mode="full"``
within 2 % of each update's norm (C7: JAX keeps bf16 moments)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qlora_tpu.models import forward as jforward
from qlora_tpu.models import get_config as jget_config
from qlora_tpu.models import init_params as jinit_params
from qlora_tpu.models.layers import QLinear as JQLinear
from qlora_tpu.quant.blockwise import quantize as jquantize
from qlora_tpu.train import make_optimizer as jmake_optimizer
from qlora_tpu.utils import checkpoint as jck
from qlora_tpu.utils import quantized_store as jqs

from qlora_tpu_torch.lora import LoraConfig
from qlora_tpu_torch.models import forward, get_config, init_lora_params, init_params
from qlora_tpu_torch.train import init_train_state, make_optimizer, make_train_step
from qlora_tpu_torch.train.optimizer import tree_leaves, tree_map
from qlora_tpu_torch.utils import (
    get_last_checkpoint, load_checkpoint, load_pytree, load_quantized, lora_from_numpy,
    lora_to_numpy, mark_completed, params_from_numpy, save_checkpoint, save_pytree,
    save_quantized,
)
from test_torch_convert import bridge, jax_to_numpy, nonzero_lora

torch.set_num_threads(2)
LR = 1e-2


def _bits(x) -> np.ndarray:
    """The bytes of an array or tensor, as an integer array of its width."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _assert_same(a, b, what=""):
    a, b = _bits(a), _bits(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _by_path(tree, prefix=""):
    """{path: tensor} of a port tree (dict keys, list indices, dataclass
    fields), so that two trees compare whatever their dicts' order."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if dataclasses.is_dataclass(tree):
        items = [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        items = list(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return {}
    return {k: v for name, sub in items for k, v in _by_path(sub, f"{prefix}/{name}").items()}


def _same_trees(port_tree, jax_tree_as_port):
    ta, tb = _by_path(port_tree), _by_path(jax_tree_as_port)
    assert sorted(ta) == sorted(tb) and ta
    for k in ta:
        _assert_same(ta[k], tb[k], k)


def _npz_layout(path):
    with np.load(path) as d:
        return {k: (d[k].dtype.str, d[k].shape) for k in d.files}


def _grads(tree_shapes, seed, scale=0.5):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * scale).astype(np.float32) for s in tree_shapes]


def _jax_steps(jopt, jtree, grads_np):
    """JAX's optimizer over `grads_np` (lists of leaves in jax order); returns
    (state, params after)."""
    state = jopt.init(jtree)
    leaves, treedef = jax.tree_util.tree_flatten(jtree)
    for g in grads_np:
        gt = treedef.unflatten([jnp.asarray(x, l.dtype) for x, l in zip(g, leaves)])
        up, state = jopt.update(gt, state, jtree)
        jtree = optax.apply_updates(jtree, up)
        leaves = jax.tree_util.tree_leaves(jtree)
    return state, jtree


def _jax_lora_grads(jlora, seed):
    leaves = jax.tree_util.tree_leaves(jlora)
    return _grads([l.shape for l in leaves], seed)


def _to_port_lora(jax_stacked_tree):
    return lora_from_numpy(jax_to_numpy(jax_stacked_tree), "cpu")


@pytest.fixture(scope="module")
def lora_setup():
    jcfg = jget_config("debug")
    jlora, jlcfg = nonzero_lora(jcfg, r=4)
    return jcfg, jlora


# ---------------------------------------------------------------------------
# LoRA + paged_adamw_32bit, both directions
# ---------------------------------------------------------------------------


def _adamw_jax_side(jlora, name="paged_adamw_32bit"):
    jopt = jmake_optimizer(name, LR, total_steps=100)
    grads = [_jax_lora_grads(jlora, s) for s in (1, 2)]
    jstate, jlora2 = _jax_steps(jopt, jlora, grads)
    return jopt, jstate, jlora2


def _next_step_grads(jlora):
    g = _jax_lora_grads(jlora, 3)
    _, treedef = jax.tree_util.tree_flatten(jlora)
    jg = treedef.unflatten([jnp.asarray(x) for x in g])
    return jg, _to_port_lora(jg)


def _adamw_state_as_port(jstate):
    inner = jstate[1][0]
    return {"count": int(inner.count), "mu": _to_port_lora(inner.mu),
            "nu": _to_port_lora(inner.nu)}


def _port_updates_close_to_jax(tup, jup, atol=1e-9, rtol=2e-5):
    want = _to_port_lora(jup)
    for a, b in zip(tree_leaves(tup), tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol, atol=atol)
    assert any((b != 0).any() for b in tree_leaves(want))


def test_lora_and_adamw_written_by_jax_load_in_the_port(tmp_path, lora_setup):
    """JAX's checkpoint after 2 updates: the port reads the adapters, the
    count and both moments bit for bit, the forward over them equals the
    forward over the adapters carried across directly, and the next update
    agrees with optax's."""
    jcfg, jlora0 = lora_setup
    jopt, jstate, jlora = _adamw_jax_side(jlora0)
    jck.save_checkpoint(str(tmp_path), 2, jlora, jstate, data_state={"micro_batches": 4})
    cfg = get_config("debug")
    like = init_lora_params(cfg, LoraConfig(r=4), seed=9, device="cpu")
    topt = make_optimizer("paged_adamw_32bit", LR, total_steps=100)
    ckpt, done = get_last_checkpoint(str(tmp_path))
    lora, state, info = load_checkpoint(ckpt, like, topt.init(like))
    assert not done and info == {"step": 2, "data_state": {"micro_batches": 4}}
    _same_trees(lora, _to_port_lora(jlora))
    want = _adamw_state_as_port(jstate)
    assert state["count"] == want["count"] == 2
    _same_trees(state["mu"], want["mu"])
    _same_trees(state["nu"], want["nu"])

    params, _ = bridge(jinit_params(jax.random.PRNGKey(0), jcfg), None, cfg)
    ids = torch.tensor([[1, 5, 9, 2, 7, 3]])
    a, _ = forward(params, lora, ids, cfg, LoraConfig(r=4))
    b, _ = forward(params, _to_port_lora(jlora), ids, cfg, LoraConfig(r=4))
    assert torch.equal(a, b)

    jg, tg = _next_step_grads(jlora)
    jup, _ = jopt.update(jg, jstate, jlora)
    tup, _ = topt.update(tg, state, lora)
    _port_updates_close_to_jax(tup, jup)


def test_lora_and_adamw_written_by_the_port_load_in_jax(tmp_path, lora_setup):
    """The port's checkpoint after the same 2 updates: the npz files have
    JAX's keys, dtypes and shapes; JAX's ``load_checkpoint`` reads the
    adapters, count and moments bit for bit, its forward over them equals
    its forward over the port's adapters, and its next update agrees."""
    jcfg, jlora0 = lora_setup
    jopt, jstate_ref, jlora_ref = _adamw_jax_side(jlora0)
    topt = make_optimizer("paged_adamw_32bit", LR, total_steps=100)
    lora = _to_port_lora(jlora0)
    state = topt.init(lora)
    for seed in (1, 2):
        g = _to_port_lora(jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jlora0),
            [jnp.asarray(x) for x in _jax_lora_grads(jlora0, seed)]))
        up, state = topt.update(g, state, lora)
        lora = tree_map(lambda p, u: p + u, lora, up)
    save_checkpoint(str(tmp_path / "port"), 2, lora, state, meta={"lr": LR})
    jck.save_checkpoint(str(tmp_path / "jax"), 2, jlora_ref, jstate_ref, meta={"lr": LR})
    for f in ("adapter_model/adapter_weights.npz", "optimizer_state.npz"):
        assert (_npz_layout(tmp_path / "port/checkpoint-2" / f)
                == _npz_layout(tmp_path / "jax/checkpoint-2" / f)), f

    jlike = jax.tree_util.tree_map(jnp.zeros_like, jlora0)
    jl, js, info = jck.load_checkpoint(str(tmp_path / "port/checkpoint-2"), jlike,
                                       jopt.init(jlike))
    assert info == {"step": 2, "lr": LR}
    _same_trees(lora, _to_port_lora(jl))
    assert int(js[1][0].count) == int(js[1][2].count) == 2
    _same_trees(state["mu"], _to_port_lora(js[1][0].mu))
    _same_trees(state["nu"], _to_port_lora(js[1][0].nu))

    params = jinit_params(jax.random.PRNGKey(0), jcfg)
    ids = jnp.asarray([[1, 5, 9, 2, 7, 3]], jnp.int32)
    lcfg = nonzero_lora(jcfg, r=4)[1]
    a, _ = jforward(params, jl, ids, jcfg, lcfg)
    b, _ = jforward(params, jax.tree_util.tree_map(jnp.asarray, lora_to_numpy(lora)), ids,
                    jcfg, lcfg)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    jg, tg = _next_step_grads(jl)
    jup, _ = jopt.update(jg, js, jl)
    tup, _ = topt.update(tg, state, lora)
    _port_updates_close_to_jax(tup, jup)


# ---------------------------------------------------------------------------
# the 8-bit optimizer state: carried exactly where the blocks line up
# ---------------------------------------------------------------------------


def _adam8_port_as_jax_arrays(state, lora):
    """The port's per-layer 8-bit lists → JAX's stacked flat arrays (the
    blocks line up): {part: {"<name>/<a|b>": array}}."""
    names = [(i, n, k) for i, layer in enumerate(lora) for n in layer for k in ("a", "b")]
    out = {}
    for part in ("m_q", "m_s", "sv_q", "sv_s"):
        by = {}
        for j, (i, n, k) in enumerate(names):
            by.setdefault(f"{n}/{k}", []).append(state[part][j].numpy())
        out[part] = {key: np.concatenate(v) for key, v in by.items()}
    return out


def _jax_adam8_flat(js):
    out = {}
    for part in ("m_q", "m_s", "sv_q", "sv_s"):
        tree = getattr(js, part)
        out[part] = {f"{n}/{k}": np.asarray(tree[n][k]) for n in tree for k in ("a", "b")}
    return out


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_adam8bit_state_carries_across_exactly_where_blocks_line_up(tmp_path, lora_setup,
                                                                     direction):
    """``debug`` with r = 4: every layer's leaf holds a multiple of 256
    values, so JAX's blocks over the stacked leaf are the port's blocks over
    each layer: codes and scales carried bit for bit, and the next update
    agrees within 2 % of the learning rate."""
    jcfg, jlora0 = lora_setup
    jopt = jmake_optimizer("adam8bit", LR, total_steps=100)
    topt = make_optimizer("adam8bit", LR, total_steps=100)
    grads = [_jax_lora_grads(jlora0, s) for s in (1, 2)]
    jstate, jlora = _jax_steps(jopt, jlora0, grads)
    lora = _to_port_lora(jlora)
    if direction == "jax_to_port":
        jck.save_checkpoint(str(tmp_path), 2, jlora, jstate)
        like = init_lora_params(get_config("debug"), LoraConfig(r=4), device="cpu")
        lora, state, _ = load_checkpoint(str(tmp_path / "checkpoint-2"), like, topt.init(like))
        _same_trees(lora, _to_port_lora(jlora))
        js = jstate
    else:
        state = topt.init(lora)
        for g in grads:             # the port's own 8-bit state after two updates
            treedef = jax.tree_util.tree_structure(jlora0)
            tg = _to_port_lora(treedef.unflatten([jnp.asarray(x) for x in g]))
            _, state = topt.update(tg, state, lora)
        save_checkpoint(str(tmp_path), 2, lora, state)
        jlike = jax.tree_util.tree_map(jnp.zeros_like, jlora0)
        jl, js, _ = jck.load_checkpoint(str(tmp_path / "checkpoint-2"), jlike, jopt.init(jlike))
        _same_trees(lora, _to_port_lora(jl))
    assert state["count"] == int(js.count) == 2
    mine, theirs = _adam8_port_as_jax_arrays(state, lora), _jax_adam8_flat(js)
    for part in mine:
        for key in theirs[part]:
            _assert_same(mine[part][key], theirs[part][key], f"{part}/{key}")
    jg, tg = _next_step_grads(jlora)
    jup, _ = jopt.update(jg, js, jlora)
    tup, _ = topt.update(tg, state, lora)
    _port_updates_close_to_jax(tup, jup, atol=0.02 * LR + 1e-9, rtol=0)


def test_adam8bit_state_that_cannot_line_up_raises_and_never_loads_wrong(tmp_path):
    """``debug-gemma`` with r = 3: wk's and wv's B hold 3 x 64 = 192 values a
    layer, so JAX's blocks run across layers.  The port resumes its own
    state exactly; loading JAX's raises a ValueError naming the optimizer;
    JAX's loader finds no key of its own for those leaves and raises."""
    jcfg = jget_config("debug-gemma")
    jlora0, _ = nonzero_lora(jcfg, r=3)
    jopt = jmake_optimizer("paged_adamw_8bit", LR, total_steps=100)
    topt = make_optimizer("paged_adamw_8bit", LR, total_steps=100)
    grads = [_jax_lora_grads(jlora0, s) for s in (1, 2)]
    jstate, jlora = _jax_steps(jopt, jlora0, grads)
    cfg = get_config("debug-gemma")
    like = init_lora_params(cfg, LoraConfig(r=3), device="cpu")

    jck.save_checkpoint(str(tmp_path / "jax"), 2, jlora, jstate)
    with pytest.raises(ValueError, match="adam8bit / paged_adamw_8bit"):
        load_checkpoint(str(tmp_path / "jax/checkpoint-2"), like, topt.init(like))

    lora = _to_port_lora(jlora)
    state = topt.init(lora)
    treedef = jax.tree_util.tree_structure(jlora0)
    for g in grads:
        _, state = topt.update(_to_port_lora(treedef.unflatten([jnp.asarray(x) for x in g])),
                               state, lora)
    save_checkpoint(str(tmp_path / "port"), 2, lora, state)
    _, back, _ = load_checkpoint(str(tmp_path / "port/checkpoint-2"), like, topt.init(like))
    assert back["count"] == state["count"] == 2
    for part in ("m_q", "m_s", "sv_q", "sv_s"):
        for a, b in zip(back[part], state[part]):
            _assert_same(a, b, part)
    jlike = jax.tree_util.tree_map(jnp.zeros_like, jlora0)
    with pytest.raises(KeyError, match="wk/b"):
        jck.load_checkpoint(str(tmp_path / "port/checkpoint-2"), jlike, jopt.init(jlike))


# ---------------------------------------------------------------------------
# mode="full": bf16 params and their moments
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def full_setup():
    jcfg = jget_config("debug")
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg, quantized=False)
    jopt = jmake_optimizer("paged_adamw_32bit", LR, total_steps=100)
    leaves = jax.tree_util.tree_leaves(jparams)
    grads = [_grads([l.shape for l in leaves], s, 0.05) for s in (4, 5)]
    jstate, jparams2 = _jax_steps(jopt, jparams, grads)
    return jcfg, jparams2, jopt, jstate, get_config("debug")


def _full_as_port(jtree, cfg):
    return params_from_numpy(jax_to_numpy(jtree), cfg, "cpu")


def test_full_tree_written_by_jax_loads_in_the_port(tmp_path, full_setup):
    """JAX's ``mode="full"`` checkpoint: the port reads every bf16 weight and
    f32 norm bit for bit, and JAX's bf16 moments exactly into its f32 ones
    (C7); the forward over what it read equals the forward over the tree
    carried across directly, and the next update lies within 2 % of each of
    optax's updates' norm."""
    jcfg, jparams, jopt, jstate, cfg = full_setup
    jck.save_checkpoint(str(tmp_path), 2, jparams, jstate)
    like = tree_map(torch.zeros_like, _full_as_port(jparams, cfg))   # the gradients' order
    topt = make_optimizer("paged_adamw_32bit", LR, total_steps=100)
    p, st, _ = load_checkpoint(str(tmp_path / "checkpoint-2"), like, topt.init(like))
    _same_trees(p, _full_as_port(jparams, cfg))
    assert st["count"] == 2
    for mine, theirs in ((st["mu"], jstate[1][0].mu), (st["nu"], jstate[1][0].nu)):
        _same_trees(mine, tree_map(lambda t: t.float(), _full_as_port(theirs, cfg)))
    ids = torch.tensor([[1, 5, 9, 2, 7, 3]])
    assert torch.equal(forward(p, None, ids, cfg)[0],
                       forward(_full_as_port(jparams, cfg), None, ids, cfg)[0])

    leaves, treedef = jax.tree_util.tree_flatten(jparams)
    jg = treedef.unflatten([jnp.asarray(x, l.dtype) for x, l in
                            zip(_grads([l.shape for l in leaves], 6, 0.05), leaves)])
    jup, _ = jopt.update(jg, jstate, jparams)
    tup, _ = topt.update(_full_as_port(jg, cfg), st, p)
    for u, w in zip(tree_leaves(tup), tree_leaves(_full_as_port(jup, cfg))):
        assert (u.float() - w.float()).norm() <= 0.02 * w.float().norm()


def test_full_tree_written_by_the_port_loads_in_jax(tmp_path, full_setup):
    """The port's ``mode="full"`` checkpoint has JAX's keys and shapes (the
    moments f32 where JAX's are bf16); JAX's loader reads the weights bit
    for bit and the moments rounded to its bf16 (as it casts to its
    skeleton's dtype: bf16 for the weights), and its forward equals its forward over the port's
    tree."""
    jcfg, jparams, jopt, jstate, cfg = full_setup
    p = _full_as_port(jparams, cfg)
    topt = make_optimizer("paged_adamw_32bit", LR, total_steps=100)
    st = {"count": 2, "mu": _full_as_port(jstate[1][0].mu, cfg),
          "nu": _full_as_port(jstate[1][0].nu, cfg)}
    st = tree_map(lambda t: t.float(), st)
    save_checkpoint(str(tmp_path / "port"), 2, p, st)
    jck.save_checkpoint(str(tmp_path / "jax"), 2, jparams, jstate)
    mine = _npz_layout(tmp_path / "port/checkpoint-2/optimizer_state.npz")
    theirs = _npz_layout(tmp_path / "jax/checkpoint-2/optimizer_state.npz")
    assert {k.replace("__bf16", "") for k in mine} == {k.replace("__bf16", "") for k in theirs}
    assert (_npz_layout(tmp_path / "port/checkpoint-2/adapter_model/adapter_weights.npz")
            == _npz_layout(tmp_path / "jax/checkpoint-2/adapter_model/adapter_weights.npz"))

    jlike = jax.tree_util.tree_map(jnp.zeros_like, jparams)
    jp, js, _ = jck.load_checkpoint(str(tmp_path / "port/checkpoint-2"), jlike,
                                    jopt.init(jlike))
    _same_trees(p, _full_as_port(jp, cfg))
    assert int(js[1][0].count) == 2
    for mine_t, theirs_t in ((st["mu"], js[1][0].mu), (st["nu"], js[1][0].nu)):
        _same_trees(tree_map(lambda t, q: t.to(q.dtype), mine_t, p), _full_as_port(theirs_t, cfg))
    ids = jnp.asarray([[1, 5, 9, 2, 7, 3]], jnp.int32)
    np.testing.assert_array_equal(np.asarray(jforward(jp, None, ids, jcfg)[0]),
                                  np.asarray(jforward(jparams, None, ids, jcfg)[0]))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_bf16_and_other_leaves_both_ways(tmp_path, direction):
    """bf16 (as uint16 bit patterns under ``__bf16``), f32, int8 and int32
    leaves, nested dicts and lists; a bf16 file read into an f32 tree is
    widened exactly."""
    rng = np.random.default_rng(0)
    f32 = rng.normal(size=(3, 5)).astype(np.float32)
    tree_t = {"w": torch.from_numpy(f32).to(torch.bfloat16), "s": torch.from_numpy(f32[0]),
              "q": {"codes": torch.from_numpy(rng.integers(-127, 128, (4, 4)).astype(np.int8))},
              "n": [torch.tensor(7, dtype=torch.int32), torch.tensor([1.5, -2.0])]}
    tree_j = {"w": jnp.asarray(f32, jnp.bfloat16), "s": jnp.asarray(f32[0]),
              "q": {"codes": jnp.asarray(tree_t["q"]["codes"].numpy())},
              "n": [jnp.asarray(7, jnp.int32), jnp.asarray([1.5, -2.0], jnp.float32)]}
    path = str(tmp_path / "t.npz")
    if direction == "jax_to_port":
        jck.save_pytree(path, tree_j)
        back = load_pytree(path, tree_map(torch.zeros_like, tree_t))
        for a, b in zip(tree_leaves(back), tree_leaves(tree_t)):
            _assert_same(a, b)
        wide = load_pytree(path, {**tree_map(torch.zeros_like, tree_t),
                                  "w": torch.zeros(3, 5)})
        assert torch.equal(wide["w"], tree_t["w"].float())
    else:
        save_pytree(path, tree_t)
        back = jck.load_pytree(path, jax.tree_util.tree_map(jnp.zeros_like, tree_j))
        for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree_j)):
            _assert_same(a, b)
    assert "w__bf16" in np.load(path).files


def test_a_dataclass_holding_trees_round_trips(tmp_path):
    """A dataclass's fields that hold dicts or lists of tensors (a
    TrainState: the adapters and an AdamW state) are saved and read back
    whole, its plain fields kept from the tree given; nothing is dropped."""
    from qlora_tpu_torch.train import TrainState

    cfg = get_config("debug")
    lora = init_lora_params(cfg, LoraConfig(r=4), seed=1, device="cpu")
    opt = make_optimizer("paged_adamw_32bit", LR, total_steps=10)
    state = TrainState(step=3, trainable=lora, opt_state=opt.init(lora))
    state.opt_state["count"] = 3
    tree_map(lambda t: t.normal_(), state.opt_state["mu"])
    save_pytree(str(tmp_path / "s.npz"), state)
    with np.load(tmp_path / "s.npz") as d:
        assert "trainable/wq/a" in d.files and "opt_state/1/0/mu/wq/a" in d.files
    fresh = init_lora_params(cfg, LoraConfig(r=4), seed=2, device="cpu")
    back = load_pytree(str(tmp_path / "s.npz"),
                       TrainState(step=0, trainable=fresh, opt_state=opt.init(fresh)))
    assert back.step == 0 and back.opt_state["count"] == 3
    _same_trees(back.trainable, lora)
    _same_trees(back.opt_state["mu"], state.opt_state["mu"])


# ---------------------------------------------------------------------------
# trainer_state.json, the scanner and the sentinel
# ---------------------------------------------------------------------------


def test_trainer_state_json_is_jax_s(tmp_path, lora_setup):
    _, jlora = lora_setup
    kw = dict(meta={"lr": 2e-4, "epoch": 1}, data_state={"micro_batches": 6, "seed": 3})
    jck.save_checkpoint(str(tmp_path / "jax"), 3, jlora, None, **kw)
    save_checkpoint(str(tmp_path / "port"), 3, _to_port_lora(jlora), None, **kw)
    a = (tmp_path / "jax/checkpoint-3/trainer_state.json").read_bytes()
    assert a == (tmp_path / "port/checkpoint-3/trainer_state.json").read_bytes()
    assert not (tmp_path / "port/checkpoint-3/optimizer_state.npz").exists()


def test_scanner_and_sentinel_are_jax_s(tmp_path):
    out = str(tmp_path / "run")
    assert get_last_checkpoint(out) == jck.get_last_checkpoint(out) == (None, False)
    os.makedirs(out)
    assert get_last_checkpoint(out) == jck.get_last_checkpoint(out) == (None, False)
    for name in ("checkpoint-5", "checkpoint-20", "checkpoint-10", "checkpoint-x",
                 "checkpoint-30.tmp", "ckpt-40"):
        os.makedirs(os.path.join(out, name))
    got = get_last_checkpoint(out)
    assert got == jck.get_last_checkpoint(out) and got[0].endswith("checkpoint-20")
    mark_completed(out)
    assert get_last_checkpoint(out) == jck.get_last_checkpoint(out) == (None, True)
    other = str(tmp_path / "other")
    jck.mark_completed(other)
    assert get_last_checkpoint(other) == (None, True)


# ---------------------------------------------------------------------------
# resume: 2 + 2 steps equal 4 straight steps, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opt_name", ["paged_adamw_32bit", "paged_adamw_8bit"])
def test_resume_two_plus_two_equals_four_straight_steps(tmp_path, lora_setup, opt_name):
    """``debug``, 2 micro-batches a step, a warmup over the first 2 steps
    (so the restored count sets the learning rate): 2 steps, a checkpoint, a
    fresh adapter and optimizer state loaded from it, 2 more steps; losses,
    gradient norms and every adapter tensor equal the uninterrupted run's
    bit for bit."""
    jcfg, jlora = lora_setup
    cfg = get_config("debug")
    params, _ = bridge(jinit_params(jax.random.PRNGKey(0), jcfg), None, cfg)
    lcfg = LoraConfig(r=4)
    lora0 = _to_port_lora(jlora)
    rng = np.random.default_rng(7)
    ids = rng.integers(3, cfg.vocab_size, size=(2, 2, 32)).astype(np.int32)
    labels = ids.copy()
    labels[:, :, :8] = -100
    batch = {"input_ids": ids, "attention_mask": np.ones_like(ids), "labels": labels}
    opt = make_optimizer(opt_name, 5e-3, total_steps=4, warmup_ratio=0.5)
    step = make_train_step(cfg, lcfg, opt, accum_steps=2, device="cpu")

    def run(state, n):
        ms = []
        for _ in range(n):
            state, m = step(state, params, batch)
            ms.append((m["loss"].item(), m["grad_norm"].item()))
        return state, ms

    straight, m_straight = run(init_train_state(lora0, opt, device="cpu"), 4)
    first, m_first = run(init_train_state(lora0, opt, device="cpu"), 2)
    save_checkpoint(str(tmp_path), first.step, first.trainable, first.opt_state,
                    data_state={"micro_batches": 4})
    ckpt, _ = get_last_checkpoint(str(tmp_path))
    fresh = init_train_state(init_lora_params(cfg, lcfg, seed=5, device="cpu"), opt,
                             device="cpu")
    lora, opt_state, info = load_checkpoint(ckpt, fresh.trainable, fresh.opt_state)
    assert info["step"] == 2 and opt_state["count"] == 2
    resumed, m_rest = run(type(fresh)(step=info["step"], trainable=lora, opt_state=opt_state), 2)
    assert m_first + m_rest == m_straight
    assert resumed.step == straight.step == 4
    for a, b in zip(tree_leaves(resumed.trainable), tree_leaves(straight.trainable)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the quantized store, both ways
# ---------------------------------------------------------------------------


def _jax_f32_absmax_params(jcfg):
    """JAX's debug params with every block linear quantized without double
    quant (f32 absmax), stacked as its init stacks them."""
    jp = jinit_params(jax.random.PRNGKey(2), jcfg)
    keys = iter(jax.random.split(jax.random.PRNGKey(3), 64))
    blocks = dict(jp["blocks"])
    for name, lin in jp["blocks"].items():
        if isinstance(lin, JQLinear):
            K, N = lin.qt.shape
            qts = [jquantize(jax.random.normal(next(keys), (K, N)) * K ** -0.5,
                             double_quant=False) for _ in range(jcfg.num_layers)]
            blocks[name] = JQLinear(
                qt=jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *qts), bias=lin.bias)
    return dict(jp, blocks=blocks)


STORES = {
    "nf4_dq": ("debug", dict(quantized=True)),
    "nf4_f32_absmax": ("debug", None),
    "int8": ("debug", dict(quantized=True, quant_type="int8")),
    "dense": ("debug", dict(quantized=False)),
    "neox": ("debug-neox", dict(quantized=True)),
    "gemma": ("debug-gemma", dict(quantized=True)),
}


@pytest.mark.parametrize("kind", list(STORES))
def test_quantized_store_both_ways(tmp_path, kind):
    """A store written by JAX loads in the port, and one written by the port
    in JAX, every tensor byte for byte, the port's forward of what it read
    equal to the original's; both packages write the same keys, dtypes and shapes
    and the same config.  JAX's ``load_quantized`` rebuilds a double-quant
    NF4 skeleton whatever the file holds (ROADMAP C8), so for f32 absmax and
    int8 JAX reads the port's file with its ``load_pytree`` over the
    matching skeleton."""
    name, how = STORES[kind]
    jcfg = jget_config(name)
    jparams = (_jax_f32_absmax_params(jcfg) if how is None
               else jinit_params(jax.random.PRNGKey(1), jcfg, **how))
    cfg = get_config(name)
    params = _full_as_port(jparams, cfg)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jqs.save_quantized(jdir, jparams, jcfg)
    save_quantized(pdir, params, cfg)
    assert _npz_layout(f"{jdir}/model.npz") == _npz_layout(f"{pdir}/model.npz")
    with open(f"{jdir}/qlora_tpu_config.json") as f:
        jmeta = json.load(f)
    with open(f"{pdir}/qlora_tpu_config.json") as f:
        pmeta = json.load(f)
    assert {k: v for k, v in pmeta.items() if k != "quant_type"} == jmeta

    ids = torch.tensor([[1, 5, 9, 2, 7, 3, 11]])
    want = forward(params, None, ids, cfg)[0]
    got, got_cfg = load_quantized(jdir, device="cpu")          # JAX → port
    assert got_cfg == cfg
    _same_trees(got, params)
    assert torch.equal(forward(got, None, ids, cfg)[0], want)
    again, _ = load_quantized(pdir, device="cpu")               # port → port
    _same_trees(again, params)

    if kind in ("nf4_f32_absmax", "int8"):                      # port → JAX
        jback = jck.load_pytree(f"{pdir}/model.npz", jparams)
    else:
        jback, jcfg2 = jqs.load_quantized(pdir)
        assert jcfg2 == jcfg
    for a, b in zip(jax.tree_util.tree_leaves(jback), jax.tree_util.tree_leaves(jparams)):
        _assert_same(a, b)                    # every leaf, so JAX's forward is its own


def test_store_entry_points_raise_without_a_device(tmp_path, monkeypatch):
    """``load_quantized`` runs on the card unless the caller names a device:
    with none present it raises, never carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("debug")
    save_quantized(str(tmp_path), init_params(cfg, device="cpu"), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_quantized(str(tmp_path))
