"""Port decode attention (plain path) against the JAX package's
``fused_decode_attention`` (the TPU kernel, in interpret mode on the CPU).

Tolerance: each output element within 2e-2 of its (row, head)'s largest
|output|.  Both round the probabilities to bf16 before the value product,
but against running maxima taken over different chunks, so a probability
may land one bf16 ulp (2^-8 relative) apart and an element moves by up to
2^-8 of the attended values' scale, even where it cancels to near 0.  A
row that attends hundreds of keys has outputs of about 0.07, so a flat
atol near 1e-2 could not see one key too many or too few; the planted-edge
test makes such a slip move the output by O(1).  The caches must be
byte-equal: the append copies bf16 values."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qlora_tpu.ops.decode_attention import fused_decode_attention as jfused

from chip_smoke import plant_edges
from qlora_tpu_torch.ops import decode_attention_plain, fused_decode_attention

torch.set_num_threads(2)


def _assert_rows_close(got, want, rtol=2e-2):
    """|got - want| <= rtol * max|want| over the last axis, elementwise."""
    d = np.abs(got - want)
    tol = rtol * np.abs(want).max(-1, keepdims=True)
    assert (d <= tol).all(), f"max excess {(d - tol).max()}"


def _mk(B, H, KVH, hd, T, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return f(B, H, hd), f(B, KVH, hd), f(B, KVH, hd), f(B, KVH, T, hd), f(B, KVH, T, hd)


def _both(arrs, lens, hd, window):
    q, nk, nv, kc, vc = arrs
    j = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
    jo, jk, jv = jfused(*j, jnp.asarray(lens, jnp.int32), sm_scale=hd ** -0.5,
                        sliding_window=window)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    to, tk, tv = fused_decode_attention(*t, torch.tensor(lens, dtype=torch.int32),
                                        sm_scale=hd ** -0.5, sliding_window=window)
    assert tk is t[3] and tv is t[4]                      # updated in place
    _assert_rows_close(to.float().numpy(), np.asarray(jo, np.float32))
    for a, b in ((tk, jk), (tv, jv)):
        np.testing.assert_array_equal(a.view(torch.uint16).numpy(),
                                      np.asarray(b).view(np.uint16))
    return to


@pytest.mark.parametrize("B,H,KVH,hd,T", [
    (4, 8, 2, 128, 256),   # GQA
    (2, 4, 4, 128, 128),   # MHA
    (3, 8, 1, 64, 384),    # MQA, hd=64
])
def test_plain_matches_jax_kernel(B, H, KVH, hd, T):
    lens = np.random.default_rng(1).integers(0, T - 1, size=(B,)).tolist()
    _both(_mk(B, H, KVH, hd, T), lens, hd, None)


@pytest.mark.parametrize("window", [None, 64])
def test_edge_lengths_and_window(window):
    B, H, KVH, hd, T = 3, 4, 2, 128, 256
    arrs = _mk(B, H, KVH, hd, T, seed=2)
    o = _both(arrs, [0, T - 1, 100], hd, window)
    # length 0 attends only the new token: the output is new_v
    nv = torch.from_numpy(arrs[2]).to(torch.bfloat16).float()
    _assert_rows_close(o[0].float().reshape(KVH, H // KVH, hd).numpy(),
                       nv[0][:, None, :].expand(KVH, H // KVH, hd).numpy())


@pytest.mark.parametrize("window", [None, 64])
def test_planted_window_edges(window):
    B, H, KVH, hd, T = 4, 8, 2, 128, 256
    lens = [0, 1, 100, T - 1]
    q, nk, nv, kc, vc = (torch.from_numpy(a) for a in _mk(B, H, KVH, hd, T, seed=8))
    plant_edges(q, kc, lens, window)
    _both([t.numpy() for t in (q, nk, nv, kc, vc)], lens, hd, window)


def test_length_at_capacity_writes_nothing():
    """lengths[b] == T: the TPU kernel attends the whole cache plus the new
    token and writes nothing; the port follows it (the jnp oracle would
    clamp the write to T-1 instead)."""
    B, H, KVH, hd, T = 2, 4, 2, 64, 128
    arrs = _mk(B, H, KVH, hd, T, seed=4)
    _both(arrs, [T, 5], hd, None)
    kc = torch.from_numpy(arrs[3]).to(torch.bfloat16)
    before = kc.clone()
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs[:3]]
    decode_attention_plain(*t, kc, kc.clone(), torch.tensor([T, T], dtype=torch.int32),
                           sm_scale=1.0)
    assert torch.equal(kc, before)


def test_any_capacity():
    """T = 200 is not 128-chunkable: the JAX package falls back to jnp on
    the TPU there; the port runs the same semantics at every T."""
    B, H, KVH, hd, T = 2, 4, 1, 64, 200
    _both(_mk(B, H, KVH, hd, T, seed=6), [150, 7], hd, 32)


def test_kernel_wrapper_checks_operands_before_launch():
    """decode_attention_cuda validates every operand in Python before a
    pointer reaches the kernel; the checks run on any device."""
    from qlora_tpu_torch.ops import decode_attention_cuda

    B, H, KVH, hd, T = 2, 4, 2, 64, 16
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in _mk(B, H, KVH, hd, T)]
    lens = torch.tensor([3, 5], dtype=torch.int32)
    cases = [
        (t[0], t[1], t[2], t[3], t[4], lens[:1]),                 # lengths not [B]
        (t[0], t[1][:, :1], t[2], t[3], t[4], lens),              # new_k not [B, KVH, hd]
        (t[0], t[1], t[2], t[3].float(), t[4], lens),             # cache not bf16
        (t[0][..., :48], t[1], t[2], t[3], t[4], lens),           # head_dim 48
    ]
    for args in cases:
        with pytest.raises(ValueError):
            decode_attention_cuda(*args, sm_scale=1.0)
