"""The split-KV decode attention kernel's plan
(``ops/decode_attention.py: decode_attention_plan``), on the CPU: every
visible key of every row is read by exactly one split, the plan depends on
neither the batch nor the lengths, its constants are the kernel's own, and
the kernel's arithmetic (per-warp online softmax over 16-key slices,
warps merged in warp order, splits merged in split order, then the new
token) written out in numpy against ``decode_attention_plain`` and the JAX
kernel in interpret mode.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``).

Tolerance: as tests/test_torch_decode_attention.py, each output element
within 2e-2 of its (row, head)'s largest |output|: the probabilities round
to bf16 against running maxima of other key ranges."""

import importlib
import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qlora_tpu.ops.decode_attention import fused_decode_attention as jfused

from chip_smoke import plant_edges
from qlora_tpu_torch.ops import decode_attention_cuda, decode_attention_plain
from qlora_tpu_torch.ops.decode_attention import MASK, decode_attention_plan

da = importlib.import_module("qlora_tpu_torch.ops.decode_attention")
SOURCE = (Path(__file__).resolve().parent.parent / "qlora_tpu_torch" / "csrc"
          / "decode_attention_split.cu")
torch.set_num_threads(2)


def _visible(length, T, window):
    lo = max(0, length - window + 1) if window else 0
    return set(range(lo, min(length, T)))


@pytest.mark.parametrize("T", [1, 63, 64, 65, 100, 130, 576, 600, 640, 2048, 5000])
@pytest.mark.parametrize("window", [None, 1, 2, 65, 256, 4096])
def test_plan_reads_every_visible_key_once(T, window):
    """For every length from 0 past the capacity, the splits' key ranges
    (from the row's first visible key, ``keys`` each) are disjoint and their
    union is the row's visible keys [max(0, len - window + 1), min(len, T));
    no split but the row's last holds a partial range, and the count of
    splits that hold keys is what the kernel computes (its ``row_keys``)."""
    for KVH, G in ((32, 1), (8, 4), (1, 8), (2, 32)):
        plan = decode_attention_plan(T, KVH, G, 128, window)
        assert plan.keys % 64 == 0 and 1 <= plan.splits <= 16
        assert plan.mtiles == -(-G // 16)
        for length in sorted({0, 1, 2, T - 1, T, T + 3, T // 2, 63, 64, 65, 448, 449}):
            if length < 0:
                continue
            spans = plan.split_keys(length, T, window)
            seen = [k for k0, k1 in spans for k in range(k0, k1)]
            assert len(seen) == len(set(seen)) and set(seen) == _visible(length, T, window)
            full = [k1 - k0 for k0, k1 in spans if k1 > k0]
            assert all(n == plan.keys for n in full[:-1])
            lo = max(0, length - window + 1) if window else 0
            hi = min(length, T)
            used = min(plan.splits, -(-(hi - lo) // plan.keys)) if hi > lo else 0
            assert used == len(full) and all(k1 <= k0 for k0, k1 in spans[used:])


def test_plan_fills_the_card_from_the_heads_and_the_capacity():
    """Enough splits for the kv heads to fill 132 SMs, or for no split to take
    more than 512 keys, at most 16 and one per 64 keys of a row's span;
    chip_smoke.py's shapes and the serve phase's cache (T = 576)."""
    ks = lambda *a: (decode_attention_plan(*a).keys, decode_attention_plan(*a).splits)
    assert ks(640, 32, 1, 128, None) == (128, 5)
    assert ks(640, 8, 4, 128, 256) == (64, 4)
    assert ks(600, 32, 1, 128, None) == (128, 5)
    assert ks(2048, 32, 1, 128, None) == (448, 5)
    assert ks(576, 32, 1, 128, None) == (128, 5)
    assert ks(8192, 32, 1, 128, None) == (512, 16)
    assert ks(65536, 8, 1, 128, None) == (4096, 16)
    assert ks(640, 4, 8, 64, 1) == (64, 1)                  # no cached key visible
    assert decode_attention_plan(100, 2, 32, 256, None) == da.AttentionPlan(64, 2, 2)
    with pytest.raises(ValueError):
        decode_attention_plan(64, 2, 4, 48, None)
    with pytest.raises(ValueError):
        decode_attention_plan(64, 1, 33, 64, None)


def test_plan_constants_match_the_kernel_and_fit_shared_memory():
    """The chunk, the query heads a CTA and the most splits are the kernel's
    own; a CTA's shared memory (the ring of padded K and V rows, the query
    heads, the warps' statistics, the barriers) fits an H100 block at every
    head dim, and the warps' partial sums fit in the ring they reuse."""
    src = SOURCE.read_text()
    c = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
         for k in ("TK", "WARPS", "ROWS", "MAX_SPLITS")}
    stages = int(re.search(r"static constexpr int STAGES = (\d+);", src).group(1))
    assert (c["TK"], c["ROWS"], c["MAX_SPLITS"]) == (da._ATTN_CHUNK, da._ATTN_ROWS,
                                                     da._ATTN_MAX_SPLITS)
    assert c["TK"] == 16 * c["WARPS"]
    for hd in (64, 128, 256):
        pitch = hd + 8
        ring = stages * 2 * c["TK"] * pitch * 2
        smem = ring + c["ROWS"] * pitch * 2 + 2 * c["WARPS"] * c["ROWS"] * 4 + 8 * stages
        assert smem <= 232448 and c["WARPS"] * c["ROWS"] * hd * 4 <= ring


def _inputs(B, H, KVH, hd, T, lens, window, planted, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(torch.bfloat16)
    q, nk, nv, kc, vc = f(B, H, hd), f(B, KVH, hd), f(B, KVH, hd), f(B, KVH, T, hd), \
        f(B, KVH, T, hd)
    if planted:
        plant_edges(q, kc, lens, window)
    return q, nk, nv, kc, vc


def test_wrapper_hands_the_kernel_one_plan_whatever_the_batch(monkeypatch):
    """What ``decode_attention_cuda`` hands the C entry, with a recording
    stand-in for it: the same (keys, splits) at B = 1 and 4 and whatever the
    lengths, and one count a call for the kernel's two launches."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(da._build, "kernel", lambda lib, fn, argtypes: entry)
    monkeypatch.setattr(da._build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(da, "_ATTN_PLANS", {})
    H, KVH, hd, T = 8, 2, 64, 640
    before = decode_attention_cuda.launches
    for B, lens in ((4, [0, 97, 383, 639]), (1, [639]), (1, [5]), (4, [640, 1, 2, 3])):
        q, nk, nv, kc, vc = _inputs(B, H, KVH, hd, T, lens, None, False, B)
        decode_attention_cuda(q, nk, nv, kc, vc, torch.tensor(lens, dtype=torch.int32),
                              sm_scale=hd ** -0.5)
    assert decode_attention_cuda.launches == before + 4
    plan = decode_attention_plan(T, KVH, H // KVH, hd, None)
    for args, B in zip(calls, (4, 1, 1, 4)):
        assert args[8:13] == (B, KVH, H // KVH, T, hd)
        assert args[15:17] == (plan.keys, plan.splits)
    assert len(calls) == 4


def _emulate(q, nk, nv, kc, vc, lens, sm_scale, window):
    """The split kernel's arithmetic, written out: per (row, kv head) and
    split, chunks of 64 keys; warp w takes keys 16 w .. 16 w + 15 of a chunk
    (none past the split: it skips the chunk), an online softmax in f32 with
    probabilities rounded to bf16 for the value product; the warps merged in
    warp order, the splits in split order, then the new token."""
    B, H, hd = q.shape
    KVH, T = kc.shape[1], kc.shape[2]
    G = H // KVH
    plan = decode_attention_plan(T, KVH, G, hd, window)
    f = lambda t: t.float().numpy()
    qf, nkf, nvf, kf, vf = f(q), f(nk), f(nv), f(kc), f(vc)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).float().numpy()
    out = np.zeros((B, H, hd), np.float32)
    for b in range(B):
        for h in range(KVH):
            qs = qf[b, h * G:(h + 1) * G]                                   # [G, hd]
            parts = []
            for k0, k1 in plan.split_keys(int(lens[b]), T, window):
                if k1 <= k0:
                    break
                warps = [(np.full(G, MASK, np.float32), np.zeros(G, np.float32),
                          np.zeros((G, hd), np.float32)) for _ in range(4)]
                for c0 in range(k0, k1, 64):
                    for w in range(4):
                        a, z = c0 + 16 * w, min(c0 + 16 * w + 16, k1)
                        if a >= z:
                            continue
                        m, l, acc = warps[w]
                        s = (qs @ kf[b, h, a:z].T).astype(np.float32) * np.float32(sm_scale)
                        mn = np.maximum(m, s.max(1))
                        alpha = np.exp(m - mn)
                        p = np.exp(s - mn[:, None])
                        warps[w] = (mn, l * alpha + p.sum(1),
                                    acc * alpha[:, None] + bf(p) @ vf[b, h, a:z])
                mc = np.max([m for m, _, _ in warps], axis=0)
                sc = [np.exp(m - mc) for m, _, _ in warps]
                parts.append((mc, sum(l * c for (_, l, _), c in zip(warps, sc)),
                              sum(acc * c[:, None] for (_, _, acc), c in zip(warps, sc))))
            M = np.max([m for m, _, _ in parts], axis=0) if parts else np.full(G, MASK, np.float32)
            num = np.zeros((G, hd), np.float32)
            L = np.zeros(G, np.float32)
            for m, l, acc in parts:                                          # split order
                sc = np.exp(m - M)
                num, L = num + acc * sc[:, None], L + l * sc
            sn = (qs @ nkf[b, h]).astype(np.float32) * np.float32(sm_scale)
            mf = np.maximum(M, sn)
            alpha, pn = np.exp(M - mf), np.exp(sn - mf)
            L = L * alpha + pn
            den = np.where(L == 0, 1.0, L)
            out[b, h * G:(h + 1) * G] = (num * alpha[:, None] + pn[:, None] * nvf[b, h]) / den[:, None]
    return out


def _close(got, want, rtol=2e-2):
    d = np.abs(got - want)
    tol = rtol * np.abs(want).max(-1, keepdims=True)
    assert (d <= tol).all(), f"max excess {(d - tol).max()}"


@pytest.mark.parametrize("B,H,KVH,hd,T,lens,window,planted", [
    (4, 8, 2, 64, 256, [0, 1, 130, 256], None, False),     # empty, one key, at capacity
    (3, 8, 8, 128, 300, [299, 64, 65], None, True),        # G = 1, five splits
    (3, 16, 2, 64, 257, [256, 100, 2], 65, True),          # a window across chunk edges
    (2, 4, 4, 64, 130, [129, 70], 1, False),                # no cached key visible
])
def test_split_merge_matches_plain_and_jax(B, H, KVH, hd, T, lens, window, planted):
    """The emulated split kernel agrees with ``decode_attention_plain`` and
    with the JAX package's kernel (interpret mode on the CPU) on the same
    bf16 inputs, and the plain version's caches take the append as JAX's."""
    q, nk, nv, kc, vc = _inputs(B, H, KVH, hd, T, lens, window, planted, T)
    got = _emulate(q, nk, nv, kc, vc, lens, hd ** -0.5, window)
    k2, v2 = kc.clone(), vc.clone()
    ref, _, _ = decode_attention_plain(q, nk, nv, k2, v2, torch.tensor(lens, dtype=torch.int32),
                                       sm_scale=hd ** -0.5, sliding_window=window)
    jo, jk, jv = jfused(*[jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, nk, nv, kc, vc)],
                        jnp.asarray(lens, jnp.int32), sm_scale=hd ** -0.5, sliding_window=window)
    _close(got, ref.float().numpy())
    _close(got, np.asarray(jo, np.float32))
    for a, j in ((k2, jk), (v2, jv)):
        np.testing.assert_array_equal(a.view(torch.uint16).numpy(), np.asarray(j).view(np.uint16))


def test_decode_sweep_edits_apply_to_the_sources():
    """Every variant of ``ops/decode_sweep.py`` finds the text it replaces in
    the decode-step kernel it edits, once, so the sweep runs on the card
    against the sources as they are."""
    from qlora_tpu_torch.ops import decode_sweep

    for source, table in (("qmm_nf4_decode.cu", decode_sweep.VARIANTS),
                          ("qmm_i8_decode.cu", decode_sweep.I8_VARIANTS),
                          ("decode_attention_split.cu", decode_sweep.ATTN_VARIANTS)):
        text = (decode_sweep.CSRC / source).read_text()
        for name, edits in table.items():
            for old, new in edits:
                assert text.count(old) == 1, (source, name, old)
                assert old != new
