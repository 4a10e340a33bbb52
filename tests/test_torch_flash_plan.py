"""The plan of the flash attention wgmma kernels (``ops/flash_attention.py:
flash_plan``), on the CPU: which tiles each CTA of the forward, dq and
dk, dv kernels walks, which of them it masks, that every visible (query,
key) pair is visited exactly once, that the plan's constants are those of
``csrc/flash_attention_wgmma.cu`` and fit an H100's shared memory, which
operands go to the kernels without a copy, and what the wrappers hand the
C entries.  The kernels themselves run only on the card
(``tests/test_torch_cuda.py``)."""

import ctypes
import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from qlora_tpu_torch.ops import flash_bwd_dkv, flash_bwd_dq, flash_fwd

FA = importlib.import_module("qlora_tpu_torch.ops.flash_attention")
SRC = (Path(__file__).resolve().parent.parent / "qlora_tpu_torch" / "csrc"
       / "flash_attention_wgmma.cu").read_text()
SMEM_PER_BLOCK = 232448            # 227 KB, what an H100 block may use

# B, H, KVH, Sq, Skv, D, causal, window, lengths: S = 1, 130, 200, 600 and the
# train run's 512; lengths 0, 1 and around a tile edge (63, 64, 65); windows
# 1, 64, 100, 256; not causal; G = 1, 2, 4; Sq != Skv
SHAPES = [
    (1, 1, 1, 1, 1, 64, True, None, (1,)),
    (2, 2, 2, 1, 1, 128, False, 1, (1, 0)),
    (2, 4, 4, 130, 130, 64, False, None, (130, 65)),
    (3, 4, 2, 200, 200, 64, True, 64, (200, 0, 1)),
    (2, 8, 8, 600, 600, 128, True, None, (600, 77)),
    (2, 8, 8, 600, 600, 128, True, None, (600, 333)),
    (2, 32, 8, 512, 512, 128, True, 256, (512, 300)),
    (2, 32, 32, 512, 512, 128, True, None, (512, 300)),
    (3, 4, 1, 200, 200, 128, True, 1, (200, 63, 1)),
    (3, 4, 2, 130, 130, 128, False, 64, (64, 65, 63)),
    (1, 2, 2, 600, 600, 64, False, 256, (600,)),
    (2, 4, 4, 384, 384, 128, True, 100, (384, 200)),
    (2, 2, 1, 128, 200, 64, True, None, (200, 129)),
    (2, 4, 4, 200, 64, 128, False, None, (64, 1)),
    # head dim 256: dq's 32-key tiles, dk and dv's 64 keys a CTA at G = 1 and 8
    (2, 16, 16, 512, 512, 256, True, None, (512, 300)),
    (2, 8, 1, 512, 512, 256, True, 256, (512, 300)),
    (2, 4, 4, 600, 600, 256, True, None, (600, 77)),
    (3, 4, 2, 200, 200, 256, True, 64, (200, 0, 1)),
    (2, 4, 4, 130, 130, 256, False, 1, (130, 65)),
]


def _ids(shape):
    B, H, KVH, Sq, Skv, D, causal, window, lens = shape
    return (f"B{B}-H{H}-KVH{KVH}-Sq{Sq}-Skv{Skv}-D{D}-{'causal' if causal else 'full'}"
            f"-w{window}-L{'_'.join(map(str, lens))}")


def _vis(Sq, Skv, lens, causal, window):
    return FA._visible(Sq, Skv, torch.tensor(lens, dtype=torch.int32), causal,
                       window)[:, 0, 0].numpy()


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_plan_visits_every_visible_pair_once(shape, kernel):
    """For each batch row (its length), the tiles the kernel's CTAs walk
    cover every visible (query, key) pair exactly once and no pair twice;
    no visited tile is wholly invisible; a tile marked "full" lies inside
    both sequences and holds no invisible pair (the kernel skips its mask);
    the grid covers every query tile (fwd, dq) or key tile (dkv: 128-key
    CTAs where G = 1, 64-key ones where G > 1 or the head dim is 256)."""
    B, H, KVH, Sq, Skv, D, causal, window, lens = shape
    plan = FA.flash_plan(B, H, KVH, Sq, Skv, D, causal, window)
    kp = getattr(plan, kernel)
    vis = _vis(Sq, Skv, lens, causal, window)
    rows, cols = kp.rows, kp.cols
    assert kp.grid == ((B * KVH, -(-Skv // cols)) if kernel == "dkv" else (B * H, -(-Sq // rows)))
    for b, n in enumerate(lens):
        seen = np.zeros((Sq, Skv), np.int32)
        for tile in range(kp.grid[1]):
            for t, mark in plan.visits(kernel, tile, n):
                r0, c0 = (t * rows, tile * cols) if kernel == "dkv" else (tile * rows, t * cols)
                assert 0 <= r0 < Sq and 0 <= c0 < Skv, (tile, t)
                block = vis[b, r0:r0 + rows, c0:c0 + cols]
                assert block.any(), f"tile {(tile, t)} holds no visible pair"
                if mark == "full":
                    assert r0 + rows <= Sq and c0 + cols <= Skv and block.all(), (tile, t)
                else:
                    assert mark == "masked"
                seen[r0:r0 + rows, c0:c0 + cols] += 1
        assert seen.max(initial=0) <= 1
        assert (seen[vis[b]] == 1).all(), f"row {b}: a visible pair is never visited"


@pytest.mark.parametrize("shape", SHAPES[:8], ids=_ids)
def test_plan_masks_only_the_tiles_an_edge_crosses(shape):
    """A tile is "full" exactly when every pair of it is visible: the mask
    runs on no tile that needs none, so the full-tile fast path is taken
    wherever it can be."""
    B, H, KVH, Sq, Skv, D, causal, window, lens = shape
    plan = FA.flash_plan(B, H, KVH, Sq, Skv, D, causal, window)
    vis = _vis(Sq, Skv, lens, causal, window)
    for kernel in ("fwd", "dq", "dkv"):
        kp = getattr(plan, kernel)
        for b, n in enumerate(lens):
            for tile in range(kp.grid[1]):
                for t, mark in plan.visits(kernel, tile, n):
                    r0, c0 = ((t * kp.rows, tile * kp.cols) if kernel == "dkv"
                              else (tile * kp.rows, t * kp.cols))
                    inside = r0 + kp.rows <= Sq and c0 + kp.cols <= Skv
                    every = inside and vis[b, r0:r0 + kp.rows, c0:c0 + kp.cols].all()
                    assert (mark == "full") == every, (kernel, b, tile, t)


def test_plan_launches_the_longest_tiles_first():
    """Causal forward and dq CTAs start at the last query tile of every (b,
    h), which sees the most keys; dk, dv CTAs at the first key tile, which the
    most query rows see; every (b, head, tile) is launched once."""
    for KVH in (2, 4):                    # dk, dv: 64-key CTAs, then 128-key ones
        plan = FA.flash_plan(2, 4, KVH, 600, 600, 128, True, None)
        for kernel in ("fwd", "dq", "dkv"):
            kp = getattr(plan, kernel)
            order = plan.order(kernel)
            heads = KVH if kernel == "dkv" else 4
            assert sorted(order) == sorted((b, h, t) for b in range(2) for h in range(heads)
                                           for t in range(kp.grid[1]))
            walks = [len(plan.visits(kernel, t, 600)) for _, _, t in order]
            assert walks == sorted(walks, reverse=True)
            assert walks[0] > walks[-1]


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def test_plan_matches_the_kernel_and_fits_shared_memory():
    """The plan's tiles, rings, threads and barrier bytes are the kernel
    source's own constants; its shared memory is the source's formula
    (alignment, tiles, ring, barriers) and stays within the 227 KB an H100
    block may use at every head dim and both dk, dv CTA sizes; the C
    entries the wrapper names exist and dispatch on both CTA sizes and, at
    head dim 256, on the kernel that splits dV and dK over the warpgroups."""
    assert FA.FWD_TILE == (_constant("FWD_BQ"), _constant("FWD_BK"), _constant("FWD_STAGES"))
    assert FA.DQ_TILE == (_constant("DQ_BQ"), _constant("DQ_BK"), _constant("DQ_STAGES"))
    assert FA.DKV_TILE == (_constant("DKV_BQ"), _constant("DKV_MANY_KEYS"),
                           _constant("DKV_STAGES"))
    assert FA.DKV_FEW_KEYS == _constant("DKV_FEW_KEYS")
    assert FA.WIDE_D == _constant("WIDE_D") == FA.HEAD_DIMS[-1]
    assert FA.DQ_WIDE_TILE == (_constant("DQ_BQ"), _constant("DQ_WIDE_BK"),
                               _constant("DQ_STAGES"))
    assert FA.DKV_WIDE_TILE == (_constant("DKV_BQ"), _constant("DKV_WIDE_KEYS"),
                                _constant("DKV_WIDE_STAGES"))
    assert "static constexpr int BK = D == WIDE_D ? DQ_WIDE_BK : DQ_BK;" in SRC
    assert "1024 + 2 * KV_BYTES + DKV_WIDE_STAGES * (STAGE_BYTES + ROW_BYTES) + BAR_BYTES;" in SRC
    for fn in ("launch_fwd", "launch_dq", "launch_dkv_wide"):
        assert f"return {fn}<WIDE_D>(" in SRC, fn
    assert {"DKV_FEW_KEYS", "DKV_MANY_KEYS"} == set(re.findall(r"launch_dkv_keys<D, (\w+)>", SRC))
    assert (FA.THREADS, FA.BAR_BYTES) == (_constant("THREADS"), _constant("BAR_BYTES"))
    for text in ("SMEM = 1024 + Q_BYTES + FWD_STAGES * STAGE_BYTES + BAR_BYTES;",
                 "SMEM = 1024 + 2 * Q_BYTES + DQ_STAGES * STAGE_BYTES + BAR_BYTES;",
                 "SMEM = 1024 + 2 * KV_BYTES + DKV_STAGES * STAGE_BYTES + BAR_BYTES;",
                 "STAGE_BYTES = 2 * T_BYTES + 2 * DKV_BQ * 4;"):
        assert text in SRC, text
    assert SRC.count("static constexpr int STAGE_BYTES = 2 * KV_BYTES;") == 2
    for D in FA.HEAD_DIMS:
        for keys, KVH in ((64, 8), (128, 32)):
            plan = FA.flash_plan(2, 32, KVH, 512, 512, D, True, 256)
            # head dim 256: dq's kv tiles of 32 keys, dk and dv 64 keys a CTA, 2 steps
            bk, keys, stages = (32, 64, 2) if D == 256 else (64, keys, 4)
            want = {"fwd": 1024 + 128 * D * 2 + 2 * (2 * 64 * D * 2) + 256,
                    "dq": 1024 + 2 * 128 * D * 2 + 3 * (2 * bk * D * 2) + 256,
                    "dkv": 1024 + 2 * keys * D * 2
                           + stages * (2 * 64 * D * 2 + 2 * 64 * 4) + 256}
            assert plan.dkv.cols == keys
            for kernel, smem in want.items():
                kp = getattr(plan, kernel)
                assert kp.smem == smem == FA.flash_smem(kernel, D, kp.rows, kp.cols, kp.stages)
                assert kp.smem <= SMEM_PER_BLOCK and kp.threads == 384
    entries = set(re.findall(r'extern "C" int (\w+)\(', SRC))
    assert entries == set(FA._WGMMA_ARGS)


def test_plan_takes_128_key_dkv_ctas_with_one_query_head_a_kv_head():
    """dk, dv CTAs own 128 keys where every kv head serves one query head
    (the train run: 2 x 32 x 4 = 256 CTAs), 64 where it serves several (GQA
    with KVH = 8: 64 CTAs of 128 keys, each walking 4 heads, would leave
    half the card idle; 64-key CTAs give 128, their two warpgroups on
    alternate steps).  The batch size never changes the choice, so a row's
    sums keep one order whatever rows share its call."""
    keys = lambda *shape: FA.flash_plan(*shape).dkv.cols
    assert keys(2, 32, 32, 512, 512, 128, True, None) == 128
    assert keys(2, 32, 32, 600, 600, 128, True, None) == 128
    assert keys(2, 32, 8, 512, 512, 128, True, 256) == 64
    assert keys(1, 4, 4, 200, 200, 64, False, None) == 128
    assert keys(1, 4, 2, 200, 200, 64, False, None) == 64
    assert {keys(B, 32, 32, 512, 512, 128, True, None) for B in (1, 2, 3, 64)} == {128}
    plan = FA.flash_plan(2, 32, 8, 512, 512, 128, True, 256)
    assert plan.dkv.grid == (16, 8) and plan.dkv.smem < FA.flash_plan(
        2, 32, 32, 512, 512, 128, True, None).dkv.smem


def test_plan_refuses_other_head_dims():
    """The kernels are instantiated for head dims 64, 128 and 256 (the Gemma
    presets).  Any other, 192 too (a multiple of 64, which the model's flash
    gate takes but no preset uses), is a ValueError that names the roadmap,
    from the plan and from the wrappers, before anything is launched."""
    assert FA.HEAD_DIMS == (64, 128, 256)
    for D in (32, 192, 320):
        with pytest.raises(ValueError, match=f"head_dim {D} .*ROADMAP"):
            FA.flash_plan(1, 2, 2, 128, 128, D, True, None)
        q = torch.zeros(1, 2, 16, D, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match=f"head_dim {D}"):
            flash_fwd(q, q, q, torch.tensor([16]))
    assert FA.flash_plan(1, 2, 2, 128, 128, 256, True, None).D == 256


def test_plan_at_head_dim_256_fits_registers_and_shared_memory():
    """At head dim 256 a warpgroup's 64 x 256 f32 accumulator is 128
    registers a thread.  The hd-128 tiles would not do: dq's Q, dO and 3
    stages of 64-key K and V take 320 KB, and dk, dv's two sums 256 registers
    (the hardware's most is 255).  The plan's tiles keep every kernel's
    accumulators within what the hd-128 kernels already hold (192 of the 240
    registers a consumer thread gets) and its shared memory within 227 KB,
    at G = 1 and G = 8 alike."""
    assert FA.flash_smem("dq", 256, *FA.DQ_TILE) > SMEM_PER_BLOCK
    assert FA.acc_regs("dkv", 128, 64, 128) == 192
    assert 2 * 256 // 2 + 64 > 255                     # dK and dV in one warpgroup
    for KVH in (16, 1):
        plan = FA.flash_plan(2, 16 if KVH == 16 else 8, KVH, 512, 512, 256, True, None)
        for kernel in ("fwd", "dq", "dkv"):
            kp = getattr(plan, kernel)
            assert kp.smem <= SMEM_PER_BLOCK, kernel
            assert FA.acc_regs(kernel, 256, kp.rows, kp.cols) <= 192, kernel
        assert (plan.fwd.rows, plan.fwd.cols, plan.fwd.stages) == FA.FWD_TILE
        assert (plan.dq.rows, plan.dq.cols, plan.dq.stages) == FA.DQ_WIDE_TILE
        assert (plan.dkv.rows, plan.dkv.cols, plan.dkv.stages) == FA.DKV_WIDE_TILE
        assert plan.dkv.grid == (2 * KVH, 8)
    for D in (64, 128):
        for KVH in (8, 32):
            plan = FA.flash_plan(2, 32, KVH, 512, 512, D, True, None)
            for kernel in ("fwd", "dq", "dkv"):
                kp = getattr(plan, kernel)
                assert FA.acc_regs(kernel, D, kp.rows, kp.cols) <= 192


def test_tma_operand_takes_model_views_and_copies_the_rest():
    """The model's [B, S, H, D] → [B, H, S, D] views (q, and GQA's k and v)
    go in without a copy; a contiguous tensor too.  A tensor whose row
    stride is no multiple of 16 bytes, whose last dim is not contiguous, or
    whose data is not 16-byte aligned is copied to a contiguous one; a
    float32 tensor is rounded to bf16 in its own layout."""
    B, S, H, KVH, D = 2, 130, 4, 2, 128
    for heads in (H, KVH):
        x = torch.randn(B, S, heads, D).to(torch.bfloat16)
        view = x.transpose(1, 2)
        got = FA._tma_operand(view)
        assert got is view and got.data_ptr() == x.data_ptr() and not got.is_contiguous()
        assert FA._strides(got) == (S * heads * D, D, heads * D)
    c = torch.randn(B, H, S, D).to(torch.bfloat16)
    assert FA._tma_operand(c) is c
    bad = [torch.randn(B, H, S, D + 4).to(torch.bfloat16)[..., :D],       # row stride 132
           torch.randn(B, H, D, S).to(torch.bfloat16).transpose(-1, -2),  # last dim strided
           torch.randn(B * H * S * D + 1).to(torch.bfloat16)[1:].view(B, H, S, D)]   # 2-byte offset
    for t in bad:
        got = FA._tma_operand(t)
        assert got is not t and got.is_contiguous() and torch.equal(got, t)
    f32 = torch.randn(B, S, H, D).transpose(1, 2)
    got = FA._tma_operand(f32)
    assert got.dtype == torch.bfloat16 and got.stride() == f32.stride()
    one = torch.randn(1, 1, 1, D).to(torch.bfloat16)
    assert FA._strides(one) == (D, D, D)


class _Recorder:
    """Stands in for the C entries: records each call's arguments, returns 0."""

    def __init__(self):
        self.calls = []

    def __call__(self, lib, entry, argtypes):
        assert lib == "flash_attention_wgmma" and argtypes == FA._WGMMA_ARGS[entry]

        def fn(*args):
            self.calls.append((entry, args))
            return 0
        return fn


def test_wrappers_launch_from_the_plan(monkeypatch):
    """The three wrappers hand the C entries the operands' own pointers and
    strides (the model's views, no copies), outputs laid out as the issue of
    the call needs them (o as [B, Sq, H, D] memory, dq, dk, dv like q, k, v),
    the dims and the plan's constants, and count each launch in
    ``launches`` and ``wgmma_launches``.  The kernels do not run here."""
    rec = _Recorder()
    monkeypatch.setattr(FA._build, "kernel", rec)
    monkeypatch.setattr(FA._build, "stream_ptr", lambda t: 7)
    for w in (flash_fwd, flash_bwd_dq, flash_bwd_dkv):
        monkeypatch.setattr(w, "launches", 0)
        monkeypatch.setattr(w, "wgmma_launches", 0)
        monkeypatch.setattr(w, "wide_launches", 0)
    B, S, H, KVH, D = 2, 200, 8, 2, 64
    mk = lambda heads: torch.randn(B, S, heads, D).to(torch.bfloat16).transpose(1, 2)
    q, k, v, do = mk(H), mk(KVH), mk(KVH), mk(H)
    L = torch.tensor([200, 63], dtype=torch.int32)
    plan = FA.flash_plan(B, H, KVH, S, S, D, True, 64)

    o, lse = flash_fwd(q, k, v, L, 0.125, True, 64)
    assert o.shape == (B, H, S, D) and o.transpose(1, 2).is_contiguous()
    assert lse.shape == (B, H, S) and lse.is_contiguous()
    entry, args = rec.calls[-1]
    assert entry == "flash_wgmma_fwd"
    assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert args[4:6] == (o.data_ptr(), lse.data_ptr())
    strides = list(ctypes.cast(args[6], ctypes.POINTER(ctypes.c_longlong))[:12])
    assert strides == [*FA._strides(q), *FA._strides(k), *FA._strides(v), *FA._strides(o)]
    assert args[7:] == (B, H, KVH, S, S, D, 0.125, 1, 64, 128, 64, 2, plan.fwd.smem, 7)

    di = torch.zeros(B, H, S)
    dq = flash_bwd_dq(q, k, v, L, do, lse, di, 0.125, True, 64)
    entry, args = rec.calls[-1]
    assert entry == "flash_wgmma_bwd_dq" and dq.stride() == q.stride()
    assert args[4] == do.data_ptr() and args[7] == dq.data_ptr()
    assert args[-5:] == (128, 64, 3, plan.dq.smem, 7)
    dk, dv = flash_bwd_dkv(q, k, v, L, do, lse, di, 0.125, True, 64)
    entry, args = rec.calls[-1]
    assert entry == "flash_wgmma_bwd_dkv" and dk.stride() == k.stride() and dv.stride() == v.stride()
    strides = list(ctypes.cast(args[9], ctypes.POINTER(ctypes.c_longlong))[:18])
    assert strides[-6:] == [*FA._strides(dk), *FA._strides(dv)]
    assert args[-5:] == (64, 64, 4, plan.dkv.smem, 7)
    for w in (flash_fwd, flash_bwd_dq, flash_bwd_dkv):
        assert (w.launches, w.wgmma_launches) == (1, 1)
    # an operand TMA cannot read (a row stride of D + 4) goes in as a contiguous copy
    odd = torch.randn(B, H, S, D + 4).to(torch.bfloat16)[..., :D]
    flash_fwd(odd, k, v, L, 0.125, True, 64)
    args = rec.calls[-1][1]
    assert args[0] != odd.data_ptr()
    assert list(ctypes.cast(args[6], ctypes.POINTER(ctypes.c_longlong))[:3]) == [H * S * D, S * D, D]
    flash_fwd(q[:, :, :0], k, v, L)           # no rows: no launch
    assert flash_fwd.launches == 2
    assert all(w.wide_launches == 0 for w in (flash_fwd, flash_bwd_dq, flash_bwd_dkv))
    # head dim 256: the WIDE_D tiles, counted in wide_launches as well
    q, k, v, do = (t[..., :1].expand(*t.shape[:-1], 256).contiguous() for t in (q, k, v, do))
    plan = FA.flash_plan(B, H, KVH, S, S, 256, True, 64)
    o, lse = flash_fwd(q, k, v, L, 0.0625, True, 64)
    assert rec.calls[-1][1][7:] == (B, H, KVH, S, S, 256, 0.0625, 1, 64, 128, 64, 2,
                                    plan.fwd.smem, 7)
    flash_bwd_dq(q, k, v, L, do, lse, di, 0.0625, True, 64)
    assert rec.calls[-1][1][-5:] == (128, 32, 3, plan.dq.smem, 7)
    flash_bwd_dkv(q, k, v, L, do, lse, di, 0.0625, True, 64)
    assert rec.calls[-1][1][-5:] == (64, 64, 2, plan.dkv.smem, 7)
    assert [(w.launches, w.wide_launches) for w in (flash_fwd, flash_bwd_dq, flash_bwd_dkv)] \
        == [(3, 1), (2, 1), (2, 1)]
