"""K-sharded storage and the Megatron partition rules against the JAX
package's: ``quantize_k_sharded``, ``local_chunk``, the vector offset's
``dequantize``, the K-sharded global view of ``qmatmul``,
``requantize_row_parallel``, the chunk-local int8 serving copy and the
partition specs.

Packed nibbles, int8 codes and a plain f32 absmax are byte-identical.  A
double-quantized chunk centres its absmax on the chunk's mean, a float sum
whose last bit depends on summation order: each entry of the offset vector
is held within one f32 ulp of JAX's, and where the two are equal bit for bit
the chunk's int8 absmax codes and meta-scales are byte-equal too (where not,
codes within ±1 and each meta-scale within the offset's ulp and its own).  A K-sharded tree made by JAX and carried across
dequantizes bit for bit."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qlora_tpu.generate.serve_int8 import requantize_params_int8 as jrequantize_int8
from qlora_tpu.models import get_config as jget_config
from qlora_tpu.models import init_params as jinit_params
from qlora_tpu.models.config import ModelConfig as JModelConfig
from qlora_tpu.ops.qmatmul import qmatmul as jqmatmul
from qlora_tpu.parallel.megatron_step import megatron_lora_specs as jlora_specs
from qlora_tpu.parallel.megatron_step import megatron_param_specs as jparam_specs
from qlora_tpu.parallel.megatron_step import requantize_row_parallel as jrequantize_rp
from qlora_tpu.quant.blockwise import QuantizedTensor as JQT
from qlora_tpu.quant.blockwise import absmax_f32 as jabsmax_f32
from qlora_tpu.quant.blockwise import dequantize as jdequantize
from qlora_tpu.quant.blockwise import local_chunk as jlocal_chunk
from qlora_tpu.quant.blockwise import quantize_k_sharded as jquantize_ks
from qlora_tpu.quant.blockwise import unpack_indices as junpack

from qlora_tpu_torch.generate.serve_int8 import requantize_linear_int8, requantize_params_int8
from qlora_tpu_torch.models import get_config, init_lora_params, init_params
from qlora_tpu_torch.models.config import ModelConfig
from qlora_tpu_torch.models.layers import DenseLinear, QLinear
from qlora_tpu_torch.lora import LoraConfig
from qlora_tpu_torch.ops import qmatmul
from qlora_tpu_torch.ops.qmatmul import qmatmul_bwd_plain, qmatmul_k_chunks, qmatmul_plain
from qlora_tpu_torch.parallel import (
    ROW_PARALLEL, SHARD_KEY, TPMesh, cut_rank_shards, make_megatron_train_step,
    megatron_lora_specs, megatron_param_specs, rank_shards, requantize_row_parallel,
    shard_params, shard_tree,
)
from qlora_tpu_torch.quant import (
    QuantizedTensor, absmax_f32, dequantize, local_chunk, quantize_k_sharded, unpack_indices,
)
from qlora_tpu_torch.utils.convert import params_from_numpy
from test_torch_convert import bridge, jax_to_numpy

torch.set_num_threads(2)

LINEARS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _weight(K, N, seed):
    w = (np.random.default_rng(seed).normal(size=(K, N)) * 0.05).astype(np.float32)
    w[:64, 1] = 0.0                                       # an all-zero block
    return w


def _carry(jqt) -> QuantizedTensor:
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))
    return QuantizedTensor(t(jqt.packed), t(jqt.absmax), t(jqt.absmax_scale),
                           t(jqt.absmax_offset), tuple(jqt.shape), jqt.block_size,
                           jqt.quant_type, jqt.k_shards)


def _jslice(jqt, i):
    """Chunk i of a JAX K-sharded tensor, as its rank sees it under shard_map."""
    n = jqt.k_shards
    rows = lambda a: None if a is None else a[i * (a.shape[0] // n):(i + 1) * (a.shape[0] // n)]
    return JQT(packed=rows(jqt.packed), absmax=rows(jqt.absmax),
               absmax_scale=rows(jqt.absmax_scale), absmax_offset=rows(jqt.absmax_offset),
               shape=jqt.shape, block_size=jqt.block_size, quant_type=jqt.quant_type,
               k_shards=n)


@pytest.mark.parametrize("quant_type", ["nf4", "fp4", "int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_quantize_k_sharded_matches_jax(tp, quant_type):
    K, N = 512 * tp // 2, 96
    w = _weight(K, N, seed=tp)
    for dq in (False, True):
        if quant_type == "int8" and dq:
            continue
        bs = K // tp if quant_type == "int8" else 64
        j = jquantize_ks(jnp.asarray(w), tp, bs, quant_type, dq)
        t = quantize_k_sharded(torch.from_numpy(w), tp, bs, quant_type, dq)
        assert (t.k_shards, t.shape, t.block_size) == (j.k_shards, tuple(j.shape), bs)
        np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
        if not dq:
            np.testing.assert_array_equal(t.absmax.numpy(), np.asarray(j.absmax))
            assert t.absmax_offset is None and t.absmax_scale is None
            continue
        joff = np.asarray(j.absmax_offset)
        assert t.absmax_offset.shape == (tp,)
        assert (np.abs(t.absmax_offset.numpy() - joff) <= np.spacing(joff)).all()
        R, S = t.absmax.shape[0] // tp, t.absmax_scale.shape[0] // tp
        for i in range(tp):
            codes, jcodes = t.absmax[i * R:(i + 1) * R].numpy(), np.asarray(j.absmax)[i * R:(i + 1) * R]
            sc, jsc = t.absmax_scale[i * S:(i + 1) * S].numpy(), np.asarray(j.absmax_scale)[i * S:(i + 1) * S]
            if t.absmax_offset[i].item() == joff[i]:
                np.testing.assert_array_equal(codes, jcodes)
                np.testing.assert_array_equal(sc, jsc)
            else:
                assert np.abs(codes.astype(np.int32) - jcodes.astype(np.int32)).max() <= 1
                # max |absmax - offset| moves with the offset: by its ulp, then rounds
                assert (np.abs(sc - jsc) <= np.spacing(joff[i]) + np.spacing(jsc)).all()


@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
@pytest.mark.parametrize("tp", [2, 4])
def test_carried_k_sharded_tensor_dequantizes_bit_exact(tp, quant_type):
    """The global view: per-chunk pairing of the nibbles and the vector
    offset, through ``unpack_indices``, ``absmax_f32`` and ``dequantize``."""
    j = jquantize_ks(jnp.asarray(_weight(64 * 300, 24, seed=7)[:128 * tp * 2]), tp, 64,
                     quant_type, True)
    t = _carry(j)
    np.testing.assert_array_equal(unpack_indices(t.packed, tp).numpy(),
                                  np.asarray(junpack(j.packed, 64, tp)))
    # compiled, as dequantize is: XLA fuses the absmax's scale and offset into one fma
    np.testing.assert_array_equal(absmax_f32(t).numpy(), np.asarray(jax.jit(jabsmax_f32)(j)))
    np.testing.assert_array_equal(dequantize(t, torch.float32).numpy(),
                                  np.asarray(jdequantize(j, jnp.float32)))
    want = np.asarray(jdequantize(j, jnp.bfloat16)).view(np.uint16)
    np.testing.assert_array_equal(dequantize(t).view(torch.uint16).numpy(), want)


@pytest.mark.parametrize("tp", [2, 4])
def test_local_chunk_matches_jax(tp):
    """A rank's rows of each leaf and its entry of the offset vector, cut
    by the row-parallel spec and re-tagged by ``local_chunk``, are JAX's
    chunk: the same dims, ``k_shards`` 1, the same weight, which is the
    global tensor's rows of that chunk."""
    K, N = 256 * tp, 40
    j = jquantize_ks(jnp.asarray(_weight(K, N, seed=11)), tp, 64, "nf4", True)
    t = _carry(j)
    spec = megatron_param_specs({"embed": None, "blocks": [{"wo": QLinear(qt=t)}],
                                 "final_norm": {}, "lm_head": DenseLinear(None)})
    whole = dequantize(t, torch.float32)
    for i in range(tp):
        mine = local_chunk(shard_tree(t, spec["blocks"][0]["wo"].qt, i, tp))
        jmine = jlocal_chunk(_jslice(j, i))
        assert mine.k_shards == jmine.k_shards == 1
        assert mine.shape == tuple(jmine.shape) == (K // tp, N)
        got = dequantize(mine, torch.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jdequantize(jmine, jnp.float32)))
        torch.testing.assert_close(got, whole[i * K // tp:(i + 1) * K // tp], rtol=0, atol=0)


def test_qmatmul_global_view_of_k_sharded_matches_jax():
    """A K-sharded tensor used whole: dequantize, then one product (the
    JAX package's path outside its kernels), forward and the input's
    gradient."""
    K, N, M = 512, 72, 6
    j = jquantize_ks(jnp.asarray(_weight(K, N, seed=3)), 2, 64, "nf4", True)
    t = _carry(j)
    x = (np.random.default_rng(4).normal(size=(M, K)) * 0.3).astype(np.float32)
    g = (np.random.default_rng(5).normal(size=(M, N))).astype(np.float32)
    jy, jvjp = jax.vjp(lambda a: jqmatmul(a, j), jnp.asarray(x, jnp.bfloat16))
    jdx = jvjp(jnp.asarray(g, jnp.bfloat16))[0]
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    y = qmatmul(xt, t)
    y.backward(torch.from_numpy(g).to(torch.bfloat16))
    ulp = lambda a: 2.0 ** -7 * np.abs(a).max()
    want = np.asarray(jy, np.float32)
    np.testing.assert_allclose(y.float().detach().numpy(), want, rtol=0, atol=ulp(want))
    wdx = np.asarray(jdx, np.float32)
    np.testing.assert_allclose(xt.grad.float().numpy(), wdx, rtol=0, atol=ulp(wdx))


# JAX's tensor-parallel test model: every row-parallel K-chunk packable at tp 4
TP_CFG = dict(arch="llama", vocab_size=512, hidden_size=512, intermediate_size=512,
              num_layers=2, num_heads=4, num_kv_heads=4)


@pytest.fixture(scope="module")
def trees():
    jcfg = JModelConfig(**TP_CFG)
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
    cfg = ModelConfig(**TP_CFG)
    params, _ = bridge(jparams, None, cfg)
    return jcfg, jparams, cfg, params


@pytest.mark.parametrize("tp", [2, 4])
def test_requantize_row_parallel_matches_jax(trees, tp):
    """wo and w_down re-packed per K-chunk as JAX's (packed bytes equal,
    offsets within an ulp), every other tensor shared; JAX's re-packed tree
    carried across keeps ``k_shards`` and the offset vector and dequantizes
    bit for bit."""
    jcfg, jparams, cfg, params = trees
    jrp = jrequantize_rp(jparams, tp)
    rp = requantize_row_parallel(params, tp)
    carried = params_from_numpy(jax_to_numpy(jrp), cfg, "cpu")
    for i, block in enumerate(rp["blocks"]):
        for name in LINEARS:
            qt, jqt = block[name].qt, jax.tree_util.tree_map(lambda a: a[i], jrp["blocks"][name].qt)
            if name not in ROW_PARALLEL:
                assert block[name] is params["blocks"][i][name]
                continue
            assert qt.k_shards == jqt.k_shards == tp
            np.testing.assert_array_equal(qt.packed.numpy(), np.asarray(jqt.packed))
            joff = np.asarray(jqt.absmax_offset)
            assert (np.abs(qt.absmax_offset.numpy() - joff) <= 2 * np.spacing(joff)).all()
            c = carried["blocks"][i][name].qt
            assert c.k_shards == tp and tuple(c.absmax_offset.shape) == (tp,)
            np.testing.assert_array_equal(dequantize(c, torch.float32).numpy(),
                                          np.asarray(jdequantize(jqt, jnp.float32)))


def test_requantize_params_int8_row_parallel_matches_jax(trees):
    """The chunk-local int8 serving copy: row-parallel linears per column per
    K-chunk (block K/2, ``k_shards`` 2), the rest per column, codes and
    scales byte-equal to JAX's; the lm_head left dense."""
    jcfg, jparams, cfg, params = trees
    jdec = jrequantize_int8(jparams, row_parallel_k_shards=2)
    dec = requantize_params_int8(params, row_parallel_k_shards=2)
    assert dec["lm_head"] is params["lm_head"] and isinstance(jdec["lm_head"], type(
        jparams["lm_head"]))
    for i, block in enumerate(dec["blocks"]):
        for name in LINEARS:
            qt = block[name].qt
            jqt = jax.tree_util.tree_map(lambda a: a[i], jdec["blocks"][name].qt)
            ks = 2 if name in ROW_PARALLEL else 1
            assert (qt.quant_type, qt.k_shards, qt.block_size) == ("int8", ks, jqt.block_size)
            assert qt.block_size == qt.shape[0] // ks
            np.testing.assert_array_equal(qt.packed.numpy(), np.asarray(jqt.packed))
            np.testing.assert_array_equal(qt.absmax.numpy(), np.asarray(jqt.absmax))
    one = requantize_linear_int8(params["blocks"][0]["w_down"], k_shards=2)
    K, N = one.qt.shape
    assert one.qt.k_shards == 2 and one.qt.block_size == K // 2
    assert tuple(one.qt.absmax.shape) == (2, N)


def _tp_dim(spec, stacked):
    """Where a JAX PartitionSpec puts "tp", in the port's per-layer terms."""
    if spec is None or "tp" not in tuple(spec):
        return None
    return tuple(spec).index("tp") - (1 if stacked else 0)


@pytest.mark.parametrize("name", ["debug", "debug-neox"])
def test_megatron_specs_match_jax(name):
    """Each tensor splits over the dimension JAX's specs shard over "tp"
    (less the stacked layer axis), for the params and the LoRA."""
    jcfg, cfg = jget_config(name), get_config(name)
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
    jrp = jrequantize_rp(jparams, 2)
    js = jparam_specs(jrp)
    params, _ = bridge(jrp, None, cfg)
    ps = megatron_param_specs(params)
    assert ps["embed"] == _tp_dim(js["embed"], False)
    assert ps["lm_head"].w == _tp_dim(js["lm_head"].w, False)
    for block in ps["blocks"]:
        for lin, spec in block.items():
            jspec = js["blocks"][lin]
            if not isinstance(spec, QLinear):
                continue
            for leaf in ("packed", "absmax", "absmax_scale", "absmax_offset"):
                assert getattr(spec.qt, leaf) == _tp_dim(getattr(jspec.qt, leaf), True), (lin, leaf)
            assert spec.bias == (None if jspec.bias is None else _tp_dim(jspec.bias, True))
    lora = init_lora_params(cfg, LoraConfig(r=4), device="cpu")
    jls = jlora_specs({n: {"a": 0, "b": 0} for n in lora[0]})
    for layer in megatron_lora_specs(lora):
        for lin, ab in layer.items():
            assert ab == {k: _tp_dim(jls[lin][k], True) for k in ("a", "b")}


def test_shard_tree_cuts_and_rejoins():
    """Column shards rejoin to the whole tensor; the embedding and lm_head
    split their features and columns; norms stay whole on every rank."""
    cfg = get_config("debug")
    params = init_params(cfg, seed=0, device="cpu")
    rp = requantize_row_parallel(params, 2)
    specs = megatron_param_specs(rp)
    shards = [shard_tree(rp, specs, r, 2) for r in range(2)]
    wq = [s["blocks"][0]["wq"].qt for s in shards]
    assert wq[0].shape == (256, 128) and wq[0].k_shards == 1
    torch.testing.assert_close(torch.cat([dequantize(q, torch.float32) for q in wq], 1),
                               dequantize(rp["blocks"][0]["wq"].qt, torch.float32), rtol=0, atol=0)
    wo = [local_chunk(s["blocks"][0]["wo"].qt) for s in shards]
    torch.testing.assert_close(torch.cat([dequantize(q, torch.float32) for q in wo], 0),
                               dequantize(rp["blocks"][0]["wo"].qt, torch.float32), rtol=0, atol=0)
    assert torch.equal(torch.cat([s["embed"] for s in shards], 1), rp["embed"])
    assert torch.equal(torch.cat([s["lm_head"].w for s in shards], 1), rp["lm_head"].w)
    for s in shards:
        assert torch.equal(s["blocks"][1]["mlp_norm"], rp["blocks"][1]["mlp_norm"])


def _same_qt(a, b):
    for leaf in ("packed", "absmax", "absmax_scale", "absmax_offset"):
        x, y = getattr(a, leaf), getattr(b, leaf)
        assert (x is None) == (y is None), leaf
        if x is not None:
            assert torch.equal(x.reshape(-1), y.reshape(-1)), leaf
    assert (a.shape, a.block_size, a.quant_type, a.k_shards) == \
        (b.shape, b.block_size, b.quant_type, b.k_shards)


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_params_quantizes_only_the_ranks_chunk(trees, tp):
    """``shard_params`` gives each rank, from the whole tree or from one
    already K-sharded, what ``requantize_row_parallel`` then a cut by the
    specs and ``local_chunk`` give, byte for byte: row-parallel linears a
    self-contained K-chunk (``k_shards`` 1), every other tensor its cut."""
    _, _, _, params = trees
    rp = requantize_row_parallel(params, tp)
    specs = megatron_param_specs(rp)
    for r in range(tp):
        want = shard_tree(rp, specs, r, tp)
        for src in (params, rp):
            got = shard_params(src, r, tp)
            assert torch.equal(got["embed"], want["embed"])
            assert torch.equal(got["lm_head"].w, want["lm_head"].w)
            for gb, wb in zip(got["blocks"], want["blocks"]):
                for name in LINEARS:
                    wqt = wb[name].qt
                    _same_qt(gb[name].qt, local_chunk(wqt) if name in ROW_PARALLEL else wqt)


def test_rank_shards_take_a_parents_cut_as_it_is(trees):
    """A parent cuts every rank's shard (``cut_rank_shards``), marked with
    its (rank, size); ``rank_shards`` takes a rank's own shard as it is
    (no copy on its device) and cuts a whole tree."""
    _, _, cfg, params = trees
    lora = init_lora_params(cfg, LoraConfig(r=4), device="cpu")
    shards = cut_rank_shards(params, lora, 2)
    for r, (p, lo) in enumerate(shards):
        mesh = TPMesh(rank=r, size=2, group=None, device=torch.device("cpu"), backend="gloo")
        assert p[SHARD_KEY] == (r, 2)
        p2, lo2 = rank_shards(p, lo, mesh)
        assert p2["blocks"][0]["wo"].qt.packed is p["blocks"][0]["wo"].qt.packed
        assert lo2[0]["wq"]["b"] is lo[0]["wq"]["b"]
        p3, lo3 = rank_shards(params, lora, mesh)
        _same_qt(p3["blocks"][1]["w_down"].qt, p["blocks"][1]["w_down"].qt)
        assert torch.equal(lo3[1]["wo"]["a"], lo[1]["wo"]["a"])
        assert lo[0]["wq"]["b"].shape[1] == lora[0]["wq"]["b"].shape[1] // 2


def test_qmatmul_k_chunks_matches_the_global_view():
    """The card's route for a whole K-sharded tensor (a sum over its chunks
    through ``qmatmul``), run here on each chunk's plain version: forward
    and the input's gradient within one bf16 ulp of the largest value of
    the global view's (dequantize, then one product)."""
    K, N, M = 512, 72, 6
    t = _carry(jquantize_ks(jnp.asarray(_weight(K, N, seed=3)), 4, 64, "nf4", True))
    rng = np.random.default_rng(4)
    x = torch.from_numpy((rng.normal(size=(M, K)) * 0.3).astype(np.float32)).to(torch.bfloat16)
    g = torch.from_numpy(rng.normal(size=(M, N)).astype(np.float32)).to(torch.bfloat16)
    xt = x.clone().requires_grad_(True)
    y = qmatmul_k_chunks(xt, t)
    y.backward(g)
    ulp = lambda a: 2.0 ** -7 * a.abs().max().item()
    want = qmatmul_plain(x, t).float()
    torch.testing.assert_close(y.float().detach(), want, rtol=0, atol=ulp(want))
    wdx = qmatmul_bwd_plain(g, t).float()
    torch.testing.assert_close(xt.grad.float(), wdx, rtol=0, atol=ulp(wdx))


def test_unpackable_k_chunks_and_the_train_step_say_what_to_do():
    cfg = dataclasses.replace(get_config("debug"), intermediate_size=640)
    params = init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="pad_intermediate_to"):
        requantize_row_parallel(params, 4)        # w_down: 160-row chunks
    with pytest.raises(ValueError, match="pad_intermediate_to"):
        shard_params(params, 0, 4)
    # the Megatron train step has no fsdp axis: it names the style that does
    mesh = types.SimpleNamespace(shape={"dp": 1, "fsdp": 2, "tp": 2})
    with pytest.raises(ValueError, match="tp_style=gather"):
        make_megatron_train_step(cfg, None, None, mesh)
