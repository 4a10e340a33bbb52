"""The int8 serving path (w8a8) against the JAX package's: the two int8
tensor-core matmuls, the ``default_impl`` routing and the offline
requantization.

The JAX side runs ``_qmm_pallas_i8_direct`` and ``_qmm_pallas_w8a8`` in
interpret mode.  Both sides quantize the rows of x and the weight to the same
int8 values and sum their products exactly in integers, so the only float
steps are the per-row and per-column scales and two bf16 roundings: the
outputs are held to one bf16 ulp of the output's scale, not to the 5 % the
int8 path keeps against the exact product."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qlora_tpu.generate.serve_int8 import (
    requantize_params_int8_unstacked as jrequantize_unstacked,
)
from qlora_tpu.models import get_config as jget_config
from qlora_tpu.models import init_params as jinit_params
from qlora_tpu.ops.qmatmul import _qmm_pallas_i8_direct, _qmm_pallas_w8a8
from qlora_tpu.ops.qmatmul import default_impl as jdefault_impl
from qlora_tpu.ops.qmatmul import qmatmul as jqmatmul
from qlora_tpu.quant import absmax_f32 as jabsmax_f32
from qlora_tpu.quant import quantize as jquantize

from qlora_tpu_torch.generate.serve_int8 import (
    requantize_linear_int8, requantize_params_int8, requantize_params_int8_unstacked,
)
from qlora_tpu_torch.models import forward, get_config, init_cache, init_params
from qlora_tpu_torch.models.layers import DenseLinear, QLinear
from qlora_tpu_torch.ops import (
    default_impl, int8_matmul_plain, qmatmul, qmm_i8_direct, qmm_i8_direct_plain,
    qmm_nf4_w8a8, qmm_nf4_w8a8_plain, quantize_rows, set_default_impl, w8a8_codes, w8a8_scales,
)
from qlora_tpu_torch.quant import dequantize, quantize
from test_torch_convert import bridge
from test_torch_quant import _carry

torch.set_num_threads(2)
# the module, which ``qlora_tpu_torch.ops`` hides behind its function of the same name
tq = sys.modules["qlora_tpu_torch.ops.qmatmul"]


def _inputs(M, K, N, seed):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(K, N)) * 0.05).astype(np.float32)
    w[:, 3] = 0.0                                   # a zero column: its scale is guarded
    x = (rng.normal(size=(M, K)) * 0.1).astype(np.float32)
    x[M - 1] = 0.0                                  # a zero row: its scale is guarded
    return w, x


def _ulp_tol(ref):
    return 2.0 ** -7 * np.abs(ref).max()


@pytest.mark.parametrize("M,K,N", [(4, 256, 384), (33, 128, 256)])
def test_i8_direct_plain_matches_jax_kernel(M, K, N):
    w, x = _inputs(M, K, N, seed=M)
    j = jquantize(jnp.asarray(w), block_size=K, quant_type="int8", double_quant=False)
    want = np.asarray(_qmm_pallas_i8_direct(jnp.asarray(x), j.packed, jabsmax_f32(j), (K, N)),
                      np.float32)
    t = _carry(j)
    got = qmm_i8_direct_plain(torch.from_numpy(x), t)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (M, N)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=_ulp_tol(want))
    assert (got[M - 1] == 0).all() and (got[:, 3] == 0).all()
    # and within the int8 path's own budget of the exact product
    exact = x @ dequantize(t, torch.float32).numpy()
    assert np.abs(got.float().numpy() - exact).max() < 0.05 * np.abs(exact).max()


@pytest.mark.parametrize("M,K,N,quant_type,dq", [
    (4, 256, 384, "nf4", True), (32, 256, 128, "nf4", False), (8, 512, 128, "fp4", True),
])
def test_nf4_w8a8_plain_matches_jax_kernel(M, K, N, quant_type, dq):
    w, x = _inputs(M, K, N, seed=K)
    j = jquantize(jnp.asarray(w), quant_type=quant_type, double_quant=dq)
    want = np.asarray(_qmm_pallas_w8a8(jnp.asarray(x), j.packed, jabsmax_f32(j), (K, N),
                                       j.block_size, j.quant_type), np.float32)
    t = _carry(j)
    got = qmm_nf4_w8a8_plain(torch.from_numpy(x), t)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=_ulp_tol(want))
    exact = x @ dequantize(t, torch.float32).numpy()
    assert np.abs(got.float().numpy() - exact).max() < 0.05 * np.abs(exact).max()


def test_w8a8_pieces_are_what_they_say():
    """Row quantization, the folded scales and the decoded int8 weight, each
    against its definition in numpy."""
    w, x = _inputs(6, 256, 64, seed=9)
    x8, xs = quantize_rows(torch.from_numpy(x))
    assert x8.dtype == torch.int8 and tuple(xs.shape) == (6, 1)
    want_xs = np.abs(x).max(1, keepdims=True) / np.float32(127.0)
    want_xs[want_xs == 0] = 1.0
    np.testing.assert_array_equal(xs.numpy(), want_xs)
    np.testing.assert_array_equal(x8.numpy(), np.round(x / want_xs).astype(np.int8))
    assert int(x8.abs().max()) == 127 and (x8[5] == 0).all()
    # half to even, as jnp.round: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2 (row maximum 127 keeps xs = 1)
    halves = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5]])
    assert quantize_rows(halves)[0].tolist() == [[127, 0, 2, 2, 0, -2, -2]]

    qt = quantize(torch.from_numpy(w))
    ratio, s_out = w8a8_scales(qt)
    assert tuple(ratio.shape) == (4, 64) and tuple(s_out.shape) == (64,)
    w8 = w8a8_codes(qt, ratio)
    assert w8.dtype == torch.int8 and int(w8.abs().max()) == 127 and (w8[:, 3] == 0).all()
    # the column's largest element decodes to +-127, and w8 * s_out is the weight to
    # within half an int8 step of the column
    back = w8.float() * s_out[None, :]
    wd = dequantize(qt, torch.float32)
    assert ((back - wd).abs() <= 0.5 * s_out[None, :] * (1 + 1e-6)).all()
    acc = int8_matmul_plain(x8, w8)
    assert acc.dtype == torch.float64
    np.testing.assert_array_equal(acc.numpy(), x8.numpy().astype(np.int64)
                                  @ w8.numpy().astype(np.int64))


@pytest.fixture
def calls(monkeypatch):
    """Count the calls of each plain version the CPU dispatch can take."""
    seen = {}
    for name in ("qmm_i8_direct_plain", "qmm_nf4_w8a8_plain", "qmatmul_plain",
                 "qmatmul_bwd_plain"):
        def counted(*a, _f=getattr(tq, name), _n=name, **kw):
            seen[_n] = seen.get(_n, 0) + 1
            return _f(*a, **kw)
        monkeypatch.setattr(tq, name, counted)
    return seen


ROUTES = [   # storage, impl, the plain version the forward must take
    ("per_column", "w8a8", "qmm_i8_direct_plain"),
    ("nf4", "w8a8", "qmm_nf4_w8a8_plain"),
    ("fp4", "w8a8", "qmm_nf4_w8a8_plain"),
    ("blockwise_int8", "w8a8", "qmatmul_plain"),
    ("per_column", None, "qmatmul_plain"),
    ("nf4", None, "qmatmul_plain"),
    ("blockwise_int8", None, "qmatmul_plain"),
]


@pytest.mark.parametrize("storage,impl,want", ROUTES)
def test_default_impl_routing(calls, storage, impl, want):
    w, x = _inputs(4, 128, 200, seed=1)               # N no multiple of 128: routed all the same
    tw = torch.from_numpy(w)
    qt = {"per_column": lambda: quantize(tw, block_size=128, quant_type="int8",
                                         double_quant=False),
          "nf4": lambda: quantize(tw), "fp4": lambda: quantize(tw, quant_type="fp4"),
          "blockwise_int8": lambda: quantize(tw, quant_type="int8")}[storage]()
    tx = torch.from_numpy(x).requires_grad_()
    with default_impl(impl):
        y = qmatmul(tx, qt)
        assert calls == {want: 1}
        y.float().sum().backward()                    # the backward is exact under "w8a8" too
    assert calls == {want: 1, "qmatmul_bwd_plain": 1}
    assert tuple(tx.grad.shape) == (4, 128)
    assert tq._IMPL_OVERRIDE[0] is None               # the scope ended


def test_default_impl_scope_and_rejections():
    set_default_impl("w8a8")
    assert tq._IMPL_OVERRIDE[0] == "w8a8"
    with default_impl(None):
        assert tq._IMPL_OVERRIDE[0] is None
    assert tq._IMPL_OVERRIDE[0] == "w8a8"
    set_default_impl(None)
    with pytest.raises(ValueError, match="only 'w8a8' or None"):
        set_default_impl("fp8")
    with pytest.raises(RuntimeError):                 # the scope ends on an exception too
        with default_impl("w8a8"):
            raise RuntimeError("x")
    assert tq._IMPL_OVERRIDE[0] is None
    # the kernels' wrappers check their operands before any pointer reaches a kernel
    w = torch.from_numpy(_inputs(4, 128, 64, 0)[0])
    x = torch.zeros(4, 128)
    with pytest.raises(ValueError, match="per-column"):
        qmm_i8_direct(x, quantize(w, quant_type="int8"))
    with pytest.raises(ValueError, match="NF4/FP4"):
        qmm_nf4_w8a8(x, quantize(w, quant_type="int8"))
    with pytest.raises(ValueError, match="does not match"):
        qmm_nf4_w8a8(x[:, :64], quantize(w))
    with pytest.raises(ValueError, match="int8 storage"):
        tq.qmm_i8_fwd(x, quantize(w))
    with pytest.raises(ValueError, match="do not read int8"):
        tq.qmm_nf4_fwd_dq(x, quantize(w, quant_type="int8"))


def test_qmatmul_under_w8a8_matches_jax():
    """The dispatch as a whole: the same tensors through both packages'
    ``qmatmul`` under ``default_impl("w8a8")``, one bf16 ulp."""
    w, x = _inputs(8, 256, 384, seed=4)
    for j in (jquantize(jnp.asarray(w), block_size=256, quant_type="int8", double_quant=False),
              jquantize(jnp.asarray(w))):
        with jdefault_impl("w8a8"):
            want = np.asarray(jqmatmul(jnp.asarray(x), j), np.float32)
        with default_impl("w8a8"):
            got = qmatmul(torch.from_numpy(x), _carry(j))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=_ulp_tol(want))


@pytest.fixture(scope="module")
def trees():
    jcfg = jget_config("debug")
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_config("debug")
    params, _ = bridge(jparams, None, cfg)
    return jcfg, jparams, cfg, params


def test_requantize_params_matches_jax(trees):
    """Codes and scales of every block linear byte-exact against JAX's tree;
    the lm_head padded to a multiple of 1024 with zero columns."""
    jcfg, jparams, cfg, params = trees
    jdec = jrequantize_unstacked(jparams)
    dec = requantize_params_int8_unstacked(params)
    assert len(dec["blocks"]) == cfg.num_layers == len(jdec["blocks"])
    assert dec["embed"] is params["embed"] and dec["final_norm"] is params["final_norm"]
    for i, block in enumerate(dec["blocks"]):
        assert block["attn_norm"] is params["blocks"][i]["attn_norm"]
        for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            qt, jqt = block[name].qt, jdec["blocks"][i][name].qt
            assert qt.quant_type == "int8" and not qt.double_quant
            assert qt.block_size == qt.shape[0] == jqt.block_size
            np.testing.assert_array_equal(qt.packed.numpy(), np.asarray(jqt.packed))
            np.testing.assert_array_equal(qt.absmax.numpy(), np.asarray(jqt.absmax))
    lm, jlm = dec["lm_head"], jdec["lm_head"]
    assert isinstance(lm, QLinear) and isinstance(params["lm_head"], DenseLinear)
    V = cfg.vocab_size
    assert lm.qt.packed.shape[1] == 1024 == jlm.qt.packed.shape[1] and V == 512
    np.testing.assert_array_equal(lm.qt.packed.numpy(), np.asarray(jlm.qt.packed))
    np.testing.assert_array_equal(lm.qt.absmax.numpy(), np.asarray(jlm.qt.absmax))
    assert (lm.qt.packed[:, V:] == 0).all() and (lm.qt.absmax[:, V:] == 0).all()
    # the other entry point builds the same tree; what is not ported says where it waits
    again = requantize_params_int8(params)
    assert torch.equal(again["blocks"][1]["w_down"].qt.packed, dec["blocks"][1]["w_down"].qt.packed)
    assert requantize_params_int8_unstacked(dec)["lm_head"] is lm      # already quantized
    with pytest.raises(NotImplementedError, match="A7"):
        requantize_params_int8(params, row_parallel_k_shards=2)
    with pytest.raises(NotImplementedError, match="A7"):
        requantize_linear_int8(params["blocks"][0]["wq"], k_shards=2)


def test_lm_head_bias_is_padded_and_logits_are_cut(trees):
    _, _, cfg, params = trees
    bias = torch.arange(cfg.vocab_size, dtype=torch.float32) * 1e-3
    with_bias = dict(params, lm_head=DenseLinear(w=params["lm_head"].w, bias=bias))
    dec = requantize_params_int8_unstacked(with_bias)
    assert tuple(dec["lm_head"].bias.shape) == (1024,)
    assert torch.equal(dec["lm_head"].bias[:512], bias) and (dec["lm_head"].bias[512:] == 0).all()
    ids = torch.tensor([[3, 17, 5, 9]])
    with default_impl("w8a8"):
        logits, _ = forward(dec, None, ids, cfg)
    exact, _ = forward(with_bias, None, ids, cfg)
    assert tuple(logits.shape) == (1, 4, cfg.vocab_size)
    assert (logits - exact).abs().max() < 0.1 * exact.abs().max()


def test_int8_decode_step_close_to_exact(trees):
    """One decode step through the serving tree stays within the per-channel
    int8 budget of the exact path (10 % of the largest |logit|, as
    tests/test_serve_int8.py), and differs from it: the int8 path ran."""
    _, _, cfg, params = trees
    dec = requantize_params_int8_unstacked(params)
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 6)))
    with torch.inference_mode():
        cache = init_cache(cfg, 2, 16, device="cpu")
        lp, cache = forward(params, None, ids, cfg, cache=cache)
        tok = lp[:, -1].argmax(-1, keepdim=True)
        c2 = {"k": [t.clone() for t in cache["k"]], "v": [t.clone() for t in cache["v"]],
              "length": cache["length"].clone()}
        exact, _ = forward(params, None, tok, cfg, cache=cache)
        with default_impl("w8a8"):
            approx, _ = forward(dec, None, tok, cfg, cache=c2)
    d = (approx - exact).abs().max().item()
    assert 0 < d < 0.1 * exact.abs().max().item()
