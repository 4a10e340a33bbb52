"""The GSPMD partition rules (qlora_tpu_torch.parallel.mesh) against the JAX
package's ``shard_params`` / ``lora_shardings`` on the conftest's 8 virtual
devices: the slice each rank of a ``(dp, fsdp, tp)`` mesh cuts for itself
equals, byte for byte, the shard JAX's device at the same coordinates holds
(``addressable_shards``), for the NF4 tree (LLaMA), the dense tree with
biases and layer norms (GPT-NeoX) and the LoRA tree.  No world is started:
the cut is a pure function of the tree and the coordinates."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from qlora_tpu.lora import LoraConfig as JLoraConfig
from qlora_tpu.models import get_config as jget_config
from qlora_tpu.models import init_lora_params as jinit_lora
from qlora_tpu.models import init_params as jinit_params
from qlora_tpu.parallel.mesh import MeshAxes as JMeshAxes
from qlora_tpu.parallel.mesh import lora_shardings as jlora_shardings
from qlora_tpu.parallel.mesh import make_mesh as jmake_mesh
from qlora_tpu.parallel.mesh import shard_params as jshard_params

from qlora_tpu_torch.models.config import get_config
from qlora_tpu_torch.models.layers import DenseLinear, QLinear
from qlora_tpu_torch.parallel import MeshAxes, cut_state
from qlora_tpu_torch.parallel.mesh import (
    MODEL_AXES, model_shard, opt_specs_like, param_specs, shard_params,
)
from qlora_tpu_torch.train import make_optimizer
from qlora_tpu_torch.train.optimizer import tree_leaves, tree_map
from qlora_tpu_torch.utils.convert import lora_from_numpy, params_from_numpy
from test_torch_convert import jax_to_numpy

torch.set_num_threads(2)

# (dp, fsdp, tp) over the 8 devices; every model width of the debug
# configs divides fsdp·tp up to 8
MESHES = [(2, 2, 2), (1, 4, 2), (1, 2, 4), (2, 1, 4), (4, 2, 1), (1, 1, 8)]


def _bytes(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().contiguous()
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return a.numpy().reshape(-1).view(np.uint8)
    return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8)


def _jax_shard(tree, device):
    """The numpy tree of what `device` holds of each leaf of a sharded JAX tree."""
    def one(x):
        return next(np.asarray(s.data) for s in x.addressable_shards if s.device == device)
    return jax_to_numpy(jax.tree_util.tree_map(one, tree))


def _port_stacked(params) -> dict:
    """The port's per-layer tree in JAX's stacked numpy layout."""
    def lin(x):
        if isinstance(x, QLinear):
            qt = x.qt
            return {"qt": {"packed": qt.packed, "absmax": qt.absmax,
                           "absmax_scale": qt.absmax_scale, "absmax_offset": qt.absmax_offset},
                    "bias": x.bias}
        if isinstance(x, DenseLinear):
            return {"w": x.w, "bias": x.bias}
        return x
    blocks = [{k: lin(v) for k, v in b.items()} for b in params["blocks"]]

    def stack(parts):
        if isinstance(parts[0], dict):
            return {k: stack([p[k] for p in parts]) for k in parts[0]}
        if parts[0] is None:
            return None
        return torch.stack(parts)
    return {"embed": params["embed"], "blocks": stack(blocks),
            "final_norm": params["final_norm"], "lm_head": lin(params["lm_head"])}


def _assert_same_bytes(port, ref, where):
    if isinstance(ref, dict):
        for k, v in ref.items():
            if k in ("shape", "block_size", "quant_type", "k_shards"):
                continue
            _assert_same_bytes(port[k], v, f"{where}/{k}")
        return
    if ref is None:
        assert port is None, where
        return
    assert tuple(port.shape) == np.asarray(ref).shape, (where, tuple(port.shape),
                                                        np.asarray(ref).shape)
    assert np.array_equal(_bytes(port), _bytes(ref)), where


@pytest.fixture(scope="module")
def trees():
    """The NF4 LLaMA tree, the dense NeoX tree and a LoRA tree, in both packages."""
    out = {}
    for tag, name, quantized in (("nf4", "debug", True), ("dense", "debug-neox", False)):
        jcfg = jget_config(name)
        jp = jinit_params(jax.random.PRNGKey(0), jcfg, quantized=quantized)
        out[tag] = (jp, params_from_numpy(jax_to_numpy(jp), get_config(name), "cpu"))
    jcfg = jget_config("debug")
    jl = jinit_lora(jax.random.PRNGKey(1), jcfg, JLoraConfig(r=8, alpha=16))
    out["lora"] = (jl, lora_from_numpy(jax_to_numpy(jl), "cpu"))
    return out


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("tag", ["nf4", "dense"])
def test_param_cut_is_jax_device_shard(trees, tag, shape):
    """Every device of the mesh: the port's cut at its (f, t) equals JAX's
    shard on that device, leaf for leaf and byte for byte (fsdp-major
    shard f·T + t; norms and the double-quant offset whole)."""
    jparams, params = trees[tag]
    axes = MeshAxes(*shape)
    mesh = jmake_mesh(JMeshAxes(*shape))
    sharded = jshard_params(jparams, mesh)
    for d in range(shape[0]):
        for f in range(shape[1]):
            for t in range(shape[2]):
                dev = mesh.devices[d, f, t]
                mine = shard_params(params, axes, f, t, "cpu")
                _assert_same_bytes(_port_stacked(mine), _jax_shard(sharded, dev),
                                   f"{tag} {shape} ({d}, {f}, {t})")


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 2, 4)], ids=lambda s: "x".join(map(str, s)))
def test_lora_whole_on_every_rank(trees, shape):
    """LoRA is replicated (JAX's ``lora_shardings``): every rank's cut is
    every device's shard, the whole tree."""
    jlora, lora = trees["lora"]
    mesh = jmake_mesh(JMeshAxes(*shape))
    placed = jax.tree_util.tree_map(jax.device_put, jlora, jlora_shardings(jlora, mesh))
    axes = MeshAxes(*shape)
    for f in range(shape[1]):
        for t in range(shape[2]):
            mine, _ = cut_state(lora, None, axes, f, t, "lora", "cpu")
            want = _jax_shard(placed, mesh.devices[0, f, t])
            for name, ad in want.items():
                for k in ("a", "b"):
                    got = torch.stack([layer[name][k] for layer in mine])
                    assert np.array_equal(_bytes(got), _bytes(ad[k])), (shape, f, t, name, k)


def test_model_shard_order_is_fsdp_major():
    """Shard f·T + t of fsdp·tp, as JAX's ``P(..., ("fsdp", "tp"))`` on a
    (dp, fsdp, tp) device grid."""
    assert MODEL_AXES == ("fsdp", "tp")
    axes = MeshAxes(2, 2, 4)
    assert [model_shard(axes, f, t) for f in range(2) for t in range(4)] == list(range(8))
    mesh = jmake_mesh(JMeshAxes(1, 2, 4))
    x = jax.device_put(np.arange(8.0)[None], NamedSharding(mesh, jax.sharding.PartitionSpec(
        None, MODEL_AXES)))
    for s in x.addressable_shards:
        f, t = (int(v[0]) for v in np.nonzero(mesh.devices[0] == s.device))
        assert float(np.asarray(s.data)[0, 0]) == model_shard(MeshAxes(1, 2, 4), f, t)


def test_moments_follow_their_tensor(trees):
    """AdamW's mu and nu of the dense tree are cut as the tensors they
    follow (JAX's ``_opt_specs_like``), the count whole; an 8-bit state of
    a sharded tree is refused, and any state of the whole adapters is whole."""
    _, params = trees["dense"]
    g = torch.Generator().manual_seed(0)
    state = {"count": 3,
             "mu": tree_map(lambda p: torch.randn(p.shape, generator=g), params),
             "nu": tree_map(lambda p: torch.rand(p.shape, generator=g), params)}
    axes = MeshAxes(1, 2, 2)
    for f in range(2):
        for t in range(2):
            mine, opt = cut_state(params, state, axes, f, t, "full", "cpu")
            assert opt["count"] == 3
            for part in ("mu", "nu"):
                want = shard_params(state[part], axes, f, t, "cpu")
                for a, b in zip(tree_leaves(opt[part]), tree_leaves(want)):
                    assert torch.equal(a, b)
                assert [tuple(a.shape) for a in tree_leaves(opt[part])] == \
                    [tuple(a.shape) for a in tree_leaves(mine)]
    opt8 = make_optimizer("adam8bit", 1e-3, total_steps=4).init(params)
    with pytest.raises(ValueError, match="AdamW"):
        opt_specs_like(opt8, params, param_specs(params))
    _, lora = trees["lora"]
    opt8 = make_optimizer("adam8bit", 1e-3, total_steps=4).init(lora)
    assert opt_specs_like(opt8, lora, [{n: {"a": None, "b": None} for n in layer}
                                       for layer in lora]) is None
