"""Port paged attention (plain path) against the JAX package's
``fused_paged_decode_attention`` and ``fused_paged_chunk_attention`` (the
TPU kernels, in interpret mode on the CPU).

Inputs come from numpy with a seed, at shapes where the JAX package takes
its Pallas kernel (head_dim % 64 == 0, page % 8 == 0, small pools, C <=
page).  Outputs within atol 3e-2 and rtol 3e-2, the tolerance of the JAX
package's own kernel tests: both round the pool probabilities to bf16 and
sum in f32 in other orders.  The pools must be byte-equal after the append,
untouched pages included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qlora_tpu.ops.paged_attention import (
    fused_paged_chunk_attention as jchunk,
    fused_paged_decode_attention as jdecode,
    paged_attention_reference as jreference,
)

from qlora_tpu_torch.ops import (
    fused_paged_chunk_attention, fused_paged_decode_attention, paged_attention_reference,
    paged_chunk_attention_cuda, paged_decode_attention_cuda,
)

torch.set_num_threads(2)
TOL = dict(atol=3e-2, rtol=3e-2)


def _mk(B, H, KVH, D, page, pps, n_pages, C=None, seed=0):
    """numpy inputs: q, new_k, new_v (with a chunk axis when C is given),
    pools filled with noise, and tables of distinct scattered pages."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    lead = (B,) if C is None else (B, C)
    q, nk, nv = f(*lead, H, D), f(*lead, KVH, D), f(*lead, KVH, D)
    kp, vp = f(n_pages, KVH, page, D), f(n_pages, KVH, page, D)
    tables = (rng.permutation(n_pages - 1)[:B * pps] + 1).reshape(B, pps).astype(np.int32)
    return [q, nk, nv, kp, vp], tables


def _bits(t):
    return t.view(torch.uint16).numpy()


def _both(fj, ft, arrs, tables, lens, sm, window):
    j = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
    # the same bf16 bits on both sides (NaN patterns included)
    t = [torch.from_numpy(np.asarray(a).view(np.uint16).copy()).view(torch.bfloat16)
         for a in j]
    jo, jk, jv = fj(*j, jnp.asarray(lens, jnp.int32), jnp.asarray(tables), sm_scale=sm,
                    sliding_window=window)
    to, tk, tv = ft(*t, torch.tensor(lens, dtype=torch.int32), torch.from_numpy(tables),
                    sm_scale=sm, sliding_window=window)
    assert tk is t[3] and tv is t[4]                      # updated in place
    np.testing.assert_allclose(to.float().numpy(), np.asarray(jo, np.float32), **TOL)
    np.testing.assert_array_equal(_bits(tk), np.asarray(jk).view(np.uint16))
    np.testing.assert_array_equal(_bits(tv), np.asarray(jv).view(np.uint16))
    return to, tk, tv


@pytest.mark.parametrize("H,KVH,D,page", [
    (4, 4, 128, 16),    # MHA
    (8, 2, 128, 16),    # GQA G=4
    (4, 1, 64, 8),      # MQA, hd=64
])
def test_decode_matches_jax_kernel(H, KVH, D, page):
    B, pps = 3, 4
    arrs, tables = _mk(B, H, KVH, D, page, pps, 32, seed=H + KVH)
    # length 0, the last slot of the table (page * pps - 1), a mid-page length
    _both(jdecode, fused_paged_decode_attention, arrs, tables, [0, page * pps - 1, 37],
          D ** -0.5, None)


def test_decode_append_clamp():
    """lengths[b] >= pps * page breaks the precondition: the TPU kernel
    attends every slot of the table and writes into the sequence's own last
    page at lengths % page (the JAX fallback would not clamp the page)."""
    B, H, KVH, D, page, pps = 2, 4, 2, 64, 8, 3
    arrs, tables = _mk(B, H, KVH, D, page, pps, 16, seed=5)
    _both(jdecode, fused_paged_decode_attention, arrs, tables, [page * pps, page * pps + 3],
          0.125, None)


def test_decode_ignores_garbage_in_skipped_pages():
    """Pages past ceil(length / page) may hold anything, NaN included."""
    B, H, KVH, D, page, pps = 2, 4, 2, 128, 16, 4
    arrs, tables = _mk(B, H, KVH, D, page, pps, 32, seed=7)
    lens = [64, 37]
    base, _, _ = _both(jdecode, fused_paged_decode_attention, arrs, tables, lens, 0.1, None)
    arrs[3][tables[1, 3]] = 1e4
    arrs[4][tables[1, 3]] = np.nan
    poisoned, _, _ = _both(jdecode, fused_paged_decode_attention, arrs, tables, lens, 0.1,
                           None)
    assert torch.isfinite(poisoned.float()).all()
    torch.testing.assert_close(poisoned[1], base[1], rtol=0, atol=0)


@pytest.mark.parametrize("window", [4, 8, 12])
def test_decode_sliding_window(window):
    B, H, KVH, D, page, pps = 3, 4, 2, 64, 8, 4
    arrs, tables = _mk(B, H, KVH, D, page, pps, 16, seed=9)
    lens = [5, 17, 30]
    # an entry wholly behind the window evicted to the scratch page 0
    tables[2, 0] = 0
    win, _, _ = _both(jdecode, fused_paged_decode_attention, arrs, tables, lens, 0.125, window)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    full, _, _ = fused_paged_decode_attention(*t, torch.tensor(lens, dtype=torch.int32),
                                              torch.from_numpy(tables), sm_scale=0.125)
    assert (full[1:].float() - win[1:].float()).abs().max() > 1e-3


def test_reference_without_append():
    B, H, KVH, D, page, pps = 3, 4, 2, 128, 16, 4
    arrs, tables = _mk(B, H, KVH, D, page, pps, 32, seed=11)
    lens = [page * pps - 1, 37, 5]
    q, _, _, kp, vp = arrs
    for window in (None, 20):
        want = jreference(jnp.asarray(q, jnp.bfloat16), jnp.asarray(kp, jnp.bfloat16),
                          jnp.asarray(vp, jnp.bfloat16), jnp.asarray(lens, jnp.int32),
                          jnp.asarray(tables), sm_scale=0.1, sliding_window=window)
        t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, kp, vp)]
        got = paged_attention_reference(t[0], t[1], t[2], torch.tensor(lens),
                                        torch.from_numpy(tables), sm_scale=0.1,
                                        sliding_window=window)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("C,lens,window", [
    (4, [60, 15, 0], None),        # capacity boundary (length + C == T), mid-page, empty
    (8, [13, 29, 47], None),       # the append straddles two pages
    (4, [40, 22, 9], 24),          # sliding window
])
def test_chunk_matches_jax_kernel(C, lens, window):
    B, H, KVH, D, page, pps = 3, 4, 2, 128, 16, 4
    arrs, tables = _mk(B, H, KVH, D, page, pps, 32, C=C, seed=C + len(lens))
    _both(jchunk, fused_paged_chunk_attention, arrs, tables, lens, 0.2, window)


def test_chunk_gqa_and_clamp():
    """GQA G=4, and a chunk that runs past the table: positions 32 and 33
    are clamped into the sequence's last page at offsets 0 and 1.  (Where
    two clamped positions fall into one 8-token append window of the TPU
    kernel, the interpreter reads the window from the unaliased input and
    drops the earlier write; on aliased memory, as on the card, the later
    position wins its slot.  This case has no such overlap.)"""
    B, H, KVH, D, page, pps, C = 2, 8, 2, 64, 16, 2, 5
    arrs, tables = _mk(B, H, KVH, D, page, pps, 8, C=C, seed=13)
    _both(jchunk, fused_paged_chunk_attention, arrs, tables, [29, 3], 0.125, None)


def test_chunk_c1_matches_decode():
    B, H, KVH, D, page, pps = 3, 4, 2, 128, 16, 4
    arrs, tables = _mk(B, H, KVH, D, page, pps, 32, seed=17)
    lens = torch.tensor([30, 17, 5], dtype=torch.int32)
    t1 = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    t2 = [x.clone() for x in t1]
    tab = torch.from_numpy(tables)
    oc, kc, vc = fused_paged_chunk_attention(t1[0][:, None], t1[1][:, None], t1[2][:, None],
                                             t1[3], t1[4], lens, tab, sm_scale=0.2)
    od, kd, vd = fused_paged_decode_attention(*t2, lens, tab, sm_scale=0.2)
    assert torch.equal(oc[:, 0], od) and torch.equal(kc, kd) and torch.equal(vc, vd)


def test_chunk_in_chunk_causality():
    """Row c of a C-chunk equals row c of the (c+1)-prefix chunk: a draft
    does not see later drafts."""
    B, H, KVH, D, page, pps, C = 1, 4, 2, 128, 16, 4, 4
    arrs, tables = _mk(B, H, KVH, D, page, pps, 32, C=C, seed=19)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    lens, tab = torch.tensor([21], dtype=torch.int32), torch.from_numpy(tables)
    full, _, _ = fused_paged_chunk_attention(*t[:3], t[3].clone(), t[4].clone(), lens, tab,
                                             sm_scale=0.2)
    for c in range(C):
        pre, _, _ = fused_paged_chunk_attention(*(x[:, :c + 1] for x in t[:3]), t[3].clone(),
                                                t[4].clone(), lens, tab, sm_scale=0.2)
        torch.testing.assert_close(full[:, c], pre[:, c], rtol=0, atol=0)


def test_kernel_wrappers_check_operands_before_launch():
    """The CUDA wrappers validate every operand in Python before a pointer
    reaches the kernel; the checks run on any device."""
    B, H, KVH, D, page, pps = 2, 4, 2, 64, 8, 2
    arrs, tables = _mk(B, H, KVH, D, page, pps, 8)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    lens, tab = torch.tensor([3, 5], dtype=torch.int32), torch.from_numpy(tables)
    bad = [
        (t[0], t[1], t[2], t[3], t[4], lens[:1], tab),            # lengths not [B]
        (t[0], t[1][:, :1], t[2], t[3], t[4], lens, tab),         # new_k not [B, KVH, hd]
        (t[0], t[1], t[2], t[3].float(), t[4], lens, tab),        # pool not bf16
        (t[0][..., :48], t[1], t[2], t[3], t[4], lens, tab),      # head_dim 48
        (t[0], t[1], t[2], t[3], t[4], lens, tab[:1]),            # tables not [B, pps]
    ]
    for args in bad:
        with pytest.raises(ValueError):
            paged_decode_attention_cuda(*args, sm_scale=1.0)
    q = t[0][:, None].expand(B, 33, H, D)                       # C * G = 66 > 64
    with pytest.raises(ValueError):
        paged_chunk_attention_cuda(q, t[1][:, None].expand(B, 33, KVH, D),
                                   t[2][:, None].expand(B, 33, KVH, D), t[3], t[4], lens, tab)
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        fused_paged_decode_attention(t[0].to("meta"), *t[1:], lens, tab)
