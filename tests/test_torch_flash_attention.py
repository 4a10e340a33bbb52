"""Port flash attention (plain path) against the JAX package's kernels.

q, k, v and the cotangents are made with numpy from a seed and given to
both packages in bf16.  JAX runs its Pallas kernels in interpret mode on
the CPU (``_flash_fwd`` directly; ``_flash_bwd`` through ``jax.grad`` of
``flash_attention`` and ``flash_attention_lse``) and its f32 oracle
``attention_reference``.

Tolerances.  Both sides round the probabilities (and ds) to bf16 before the
products that consume them, JAX against the running maximum of its kv
tiles, the port against the row's maximum, and sum in other orders; the
outputs are rounded to bf16 (2^-8 relative).  So o must lie within 2e-2 of
its (batch, head) slice's largest |o|, lse within 1e-3, and each gradient
within 2e-2 of its slice's largest |gradient| (3e-2 with GQA, where JAX
rounds each query head's dk, dv to bf16 before it sums the group).  What
must be exactly 0 (empty rows, keys past the length) is checked for 0."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qlora_tpu.ops.flash_attention import _flash_fwd
from qlora_tpu.ops.flash_attention import attention_reference as jreference
from qlora_tpu.ops.flash_attention import flash_attention as jflash
from qlora_tpu.ops.flash_attention import flash_attention_lse as jflash_lse

from qlora_tpu_torch.ops import (
    attention_reference, flash_attention, flash_attention_lse, flash_bwd_plain,
    flash_fwd, flash_fwd_plain,
)
from qlora_tpu_torch.ops.flash_attention import EMPTY_LSE

# the module itself: the package's function of the same name hides it
_FA = importlib.import_module("qlora_tpu_torch.ops.flash_attention")

torch.set_num_threads(2)

CASES = {   # B, H, KVH, S, D, lengths, causal, window
    "causal": (2, 2, 2, 128, 64, (128, 58), True, None),
    "not_causal_padded": (2, 2, 2, 128, 64, (128, 58), False, None),
    "two_tiles": (1, 2, 2, 256, 64, (256,), True, None),
    "gqa": (1, 4, 2, 128, 64, (100,), True, None),
    "window4": (1, 2, 2, 256, 64, (256,), True, 4),
    "window64": (1, 2, 2, 256, 64, (256,), True, 64),
    "window200_gqa": (1, 4, 1, 256, 64, (256,), True, 200),
    "empty_row": (2, 1, 1, 128, 64, (128, 0), False, None),
    "hd128": (1, 2, 2, 128, 128, (90,), True, None),
    # head dim 256 (the Gemma presets), MQA as gemma-2b
    "hd256": (1, 2, 1, 256, 256, (256,), True, None),
    "hd256_window": (1, 2, 1, 256, 256, (200,), True, 64),
}


def _inputs(name):
    B, H, KVH, S, D, lens, causal, window = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    arrs = dict(q=mk(B, H, S, D), k=mk(B, KVH, S, D), v=mk(B, KVH, S, D),
                do=mk(B, H, S, D), dlse=0.3 * mk(B, H, S))
    return arrs, np.asarray(lens, np.int32), D ** -0.5, causal, window


def _j(a):
    return jnp.asarray(a, jnp.bfloat16)


def _t(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _close(got, want, frac, what):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    tol = frac * np.maximum(np.abs(want).max(axis=(-2, -1), keepdims=True), 1e-6)
    excess = (np.abs(got - want) - tol).max()
    assert excess <= 0, f"{what}: exceeds {frac} of the slice's max by {excess}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax_kernel_and_oracle(name, monkeypatch):
    a, lens, sm, causal, window = _inputs(name)
    want_o, want_lse = _flash_fwd(_j(a["q"]), _j(a["k"]), _j(a["v"]), jnp.asarray(lens), sm,
                                  causal, 128, 128, window)
    want_lse = np.asarray(want_lse)[..., 0]
    o, lse = flash_fwd_plain(_t(a["q"]), _t(a["k"]), _t(a["v"]), torch.from_numpy(lens), sm,
                             causal, window)
    assert o.dtype == torch.bfloat16 and o.shape == a["q"].shape
    assert lse.dtype == torch.float32 and lse.shape == a["q"].shape[:3]
    _close(o, want_o, 2e-2, "o against _flash_fwd")
    empty = want_lse > 1e37
    np.testing.assert_array_equal(lse.numpy() == np.float32(EMPTY_LSE), empty)
    np.testing.assert_allclose(lse.numpy()[~empty], want_lse[~empty], rtol=1e-3, atol=1e-3)
    assert (o.float().numpy()[empty] == 0).all()
    # the f32 oracle, where a row sees a key at all (GQA: repeat the kv heads for JAX's)
    G = a["q"].shape[1] // a["k"].shape[1]
    ref = jreference(_j(a["q"]), jnp.repeat(_j(a["k"]), G, 1), jnp.repeat(_j(a["v"]), G, 1),
                     jnp.asarray(lens), sm, causal, window)
    ref = np.where(empty[..., None], 0, np.asarray(ref, np.float32))
    _close(o, ref, 2e-2, "o against JAX attention_reference")
    mine = attention_reference(_t(a["q"]), _t(a["k"]), _t(a["v"]), torch.from_numpy(lens), sm,
                               causal, window)
    _close(np.where(empty[..., None], 0, mine.float().numpy()), ref, 2e-2,
           "the port's attention_reference against JAX's")
    # on a CPU tensor the public op dispatches to the plain version (a spy,
    # not a bit-for-bit comparison of two calls: MKL's f32 GEMMs inside the
    # einsums promise no run-to-run bit equality), and agrees with the kernel
    calls = []
    plain = _FA.flash_fwd_plain
    monkeypatch.setattr(_FA, "flash_fwd_plain", lambda *args: calls.append(args) or plain(*args))
    got = flash_attention(_t(a["q"]), _t(a["k"]), _t(a["v"]), torch.from_numpy(lens), sm,
                          causal, window)
    assert len(calls) == 1 and got.dtype == torch.bfloat16 and got.shape == o.shape
    _close(got, want_o, 2e-2, "flash_attention against _flash_fwd")


@pytest.mark.parametrize("name", sorted(CASES))
def test_grads_match_jax_flash_attention(name):
    a, lens, sm, causal, window = _inputs(name)
    _, vjp = jax.vjp(lambda q, k, v: jflash(q, k, v, jnp.asarray(lens), sm, causal, 128, 128,
                                            window), _j(a["q"]), _j(a["k"]), _j(a["v"]))
    want = vjp(_j(a["do"]))
    q, k, v = (_t(a[n]).requires_grad_() for n in "qkv")
    flash_attention(q, k, v, torch.from_numpy(lens), sm, causal, window).backward(_t(a["do"]))
    frac = 3e-2 if q.shape[1] != k.shape[1] else 2e-2
    for n, got, w in zip("qkv", (q.grad, k.grad, v.grad), want):
        assert got.dtype == torch.bfloat16
        _close(got, w, frac, f"d{n}")
    for b, n in enumerate(lens):           # keys past the length get exactly nothing
        assert (k.grad[b, :, n:] == 0).all() and (v.grad[b, :, n:] == 0).all()
        if n == 0:
            assert (q.grad[b] == 0).all()


@pytest.mark.parametrize("name", ["causal", "gqa", "window64", "empty_row"])
def test_grads_with_lse_cotangent_match_jax(name):
    a, lens, sm, causal, window = _inputs(name)
    (_, jl), vjp = jax.vjp(
        lambda q, k, v: jflash_lse(q, k, v, jnp.asarray(lens), sm, causal, 128, 128, window),
        _j(a["q"]), _j(a["k"]), _j(a["v"]))
    want = vjp((_j(a["do"]), jnp.asarray(a["dlse"])))
    q, k, v = (_t(a[n]).requires_grad_() for n in "qkv")
    o, lse = flash_attention_lse(q, k, v, torch.from_numpy(lens), sm, causal, window)
    assert lse.shape == jl.shape
    torch.autograd.backward((o, lse), (_t(a["do"]), torch.from_numpy(a["dlse"])))
    frac = 3e-2 if q.shape[1] != k.shape[1] else 2e-2
    for n, got, w in zip("qkv", (q.grad, k.grad, v.grad), want):
        _close(got, w, frac, f"d{n} with dlse")
    # the lse cotangent matters: without it dq differs
    q2, k2, v2 = (_t(a[n]).requires_grad_() for n in "qkv")
    flash_attention(q2, k2, v2, torch.from_numpy(lens), sm, causal, window).backward(
        _t(a["do"]))
    assert (q.grad.float() - q2.grad.float()).abs().max() > 1e-2


@pytest.mark.parametrize("name", ["causal", "gqa", "window64", "not_causal_padded", "hd128",
                                  "hd256_window"])
def test_plain_backward_matches_autograd_of_reference(name):
    """The explicit dq/dk/dv formulas against torch.autograd through the
    f32 oracle, with an lse cotangent through logsumexp of the same scores."""
    a, lens, sm, causal, window = _inputs(name)
    L = torch.from_numpy(lens)
    q, k, v = (_t(a[n]).float().requires_grad_() for n in "qkv")
    do, dlse = _t(a["do"]).float(), torch.from_numpy(a["dlse"])
    o_ref = attention_reference(q, k, v, L, sm, causal, window)
    B, H, S, D = q.shape
    KVH = k.shape[1]
    s = torch.einsum("bkgqd,bksd->bkgqs", q.reshape(B, KVH, H // KVH, S, D), k) * sm
    col, row = torch.arange(S)[None, :], torch.arange(S)[:, None]
    vis = (col < L[:, None, None]) & ((col <= row) | (not causal))
    if window:
        vis = vis & (row - col < window)
    lse_ref = torch.logsumexp(s.masked_fill(~vis[:, None, None], float("-inf")), -1)
    ((o_ref * do).sum() + (lse_ref.reshape(B, H, S) * dlse).sum()).backward()
    o, lse = flash_fwd_plain(_t(a["q"]), _t(a["k"]), _t(a["v"]), L, sm, causal, window)
    dq, dk, dv = flash_bwd_plain(_t(a["q"]), _t(a["k"]), _t(a["v"]), L, o, lse, _t(a["do"]),
                                 sm, causal, window, dlse=dlse)
    for n, got, want in (("q", dq, q.grad), ("k", dk, k.grad), ("v", dv, v.grad)):
        _close(got, want.numpy(), 2e-2, f"d{n}")


def test_any_length_runs_the_same_function():
    """S = 100 is no multiple of any tile: the port takes it (the TPU kernel
    needs 128-multiples); held against the port's own oracle."""
    rng = np.random.default_rng(9)
    mk = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(torch.bfloat16)
    q, k, v = mk(2, 4, 100, 64), mk(2, 2, 100, 64), mk(2, 2, 100, 64)
    L = torch.tensor([100, 37], dtype=torch.int32)
    o = flash_attention(q, k, v, L, 0.125, True, 70)    # every row still sees a key
    _close(o, attention_reference(q, k, v, L, 0.125, True, 70).float().numpy(), 2e-2, "o")


def test_kernel_wrappers_check_operands_before_launch():
    q = torch.zeros(1, 4, 64, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        flash_fwd(q, q, q, torch.tensor([64]))
    q = torch.zeros(1, 4, 64, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="pair up"):
        flash_fwd(q, q[:, :3], q[:, :3], torch.tensor([64]))
    with pytest.raises(ValueError, match="kv_lengths"):
        flash_fwd(q, q, q, torch.tensor([64, 64]))
