"""The split-KV paged chunk kernel's plan (``ops/paged_attention.py:
paged_chunk_plan``), on the CPU: every visible (row, key) pair of a chunk is
read by exactly one split and no invisible key is counted, over capacities,
page sizes, windows, chunk lengths and heads; the plan depends on neither the
batch nor the lengths; its constants are the kernel's own; what the wrapper
hands the C entry; and the kernel's arithmetic (per-warp online softmax over
16-key slices with each (row, key) pair masked on its own, warps merged in
warp order, splits in split order, then the chunk's own keys) written out in
numpy against ``paged_chunk_plain`` and the JAX kernel in interpret mode.
The decode step is the chunk of one token (C = 1): the same plan, what the
decode wrapper hands the C entry, and the emulated kernel against
``paged_decode_plain`` and the JAX decode kernel.  The kernel itself runs
only on the card (``tests/test_torch_cuda.py``).

Tolerance: as tests/test_torch_paged_attention.py and the card's checks,
each output element within 2e-2 of its (row, head)'s largest |output|: the
pool probabilities round to bf16 against running maxima of other key
ranges."""

import importlib
import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qlora_tpu.ops.paged_attention import fused_paged_chunk_attention as jchunk
from qlora_tpu.ops.paged_attention import fused_paged_decode_attention as jdecode

from chip_smoke import plant_paged_edges
from qlora_tpu_torch.ops import paged_chunk_attention_cuda, paged_chunk_plain
from qlora_tpu_torch.ops import paged_decode_attention_cuda, paged_decode_plain
from qlora_tpu_torch.ops.decode_attention import MASK

pa = importlib.import_module("qlora_tpu_torch.ops.paged_attention")
da = importlib.import_module("qlora_tpu_torch.ops.decode_attention")
SOURCE = (Path(__file__).resolve().parent.parent / "qlora_tpu_torch" / "csrc"
          / "paged_attention_split.cu")
torch.set_num_threads(2)


def _visible(length, c, window):
    """Pool positions row c of a chunk sees when its sequence holds `length`."""
    lo = max(0, length + c - window + 1) if window else 0
    return set(range(lo, length))


def _first_visible(length, c, window):
    """The kernel's per-row mask: positions at or after this one."""
    return length + c - window + 1 if window else 0


@pytest.mark.parametrize("page,pps", [(8, 3), (16, 4), (64, 16), (16, 40)])
@pytest.mark.parametrize("window", [None, 1, 12, 256])
@pytest.mark.parametrize("C,G", [(2, 1), (5, 4), (16, 2), (5, 1), (1, 1), (1, 4)])
def test_plan_reads_every_visible_pair_once(page, pps, window, C, G):
    """For lengths at page edges, mid-page and at capacity - C: the splits'
    key ranges are disjoint; a key is counted for a row exactly when it lies
    in a split that holds keys and at or after the row's first visible
    position, which gives each row exactly its visible pool keys; the CTA
    rows of 16 cover the C * G query rows once; no split reads a page past
    ceil(len / page) or one wholly behind the window."""
    T = page * pps
    plan = pa.paged_chunk_plan(T, 8, G, C, 128, window)
    assert plan.keys % 64 == 0 and 1 <= plan.splits <= 16
    assert plan.mtiles == -(-C * G // 16)
    rows = [r for t in range(plan.mtiles) for r in range(16 * t, min(16 * t + 16, C * G))]
    assert rows == list(range(C * G))
    lengths = {0, 1, page - 1, page, page + 1, T // 2, T - C, max(0, T - C - 1)}
    for length in sorted(n for n in lengths if 0 <= n <= T - C):
        spans = plan.split_keys(length, T, window)
        seen = [k for k0, k1 in spans for k in range(k0, k1)]
        assert len(seen) == len(set(seen))
        for c in range(C):
            counted = {k for k in seen if k >= _first_visible(length, c, window)}
            assert counted == _visible(length, c, window), (length, c)
        pages = {k // page for k in seen}
        lo = max(0, length - window + 1) if window else 0
        assert all(p < -(-length // page) and (p + 1) * page > lo for p in pages)


def test_plan_depends_on_the_capacity_heads_chunk_and_window_only():
    """The plan's arguments are the capacity, the heads, C, hd, the window
    and the SM count: serve-paged-spec's shapes, and the decode plan's split
    of the keys with CTA rows of 16 query rows."""
    assert pa.paged_chunk_plan(1024, 32, 1, 5, 128, None) == da.AttentionPlan(256, 4, 1)
    assert pa.paged_chunk_plan(1024, 8, 4, 5, 128, 256) == da.AttentionPlan(64, 4, 2)
    assert pa.paged_chunk_plan(64, 2, 4, 16, 64, 12) == da.AttentionPlan(64, 1, 4)
    for T, KVH, G, C, hd, w in ((1024, 32, 1, 5, 128, None), (640, 8, 4, 3, 64, 100)):
        d = da.decode_attention_plan(T, KVH, 1, hd, w)
        p = pa.paged_chunk_plan(T, KVH, G, C, hd, w)
        assert (p.keys, p.splits) == (d.keys, d.splits)
    # the decode step, the chunk of one token: one CTA row of its G query heads
    assert pa.paged_chunk_plan(1024, 32, 1, 1, 128, None) == da.AttentionPlan(256, 4, 1)
    assert pa.paged_chunk_plan(1024, 8, 4, 1, 128, 256) == da.AttentionPlan(64, 4, 1)
    for C, G in ((0, 4), (17, 4), (65, 1), (1, 65)):
        with pytest.raises(ValueError):
            pa.paged_chunk_plan(1024, 8, G, C, 128, None)


def test_plan_constants_match_the_kernel_and_fit_shared_memory():
    """The chunk, the rows a CTA, the most splits and C * G's limit are the
    kernel's own; a CTA's shared memory (the ring of padded K and V rows,
    the query rows, the warps' statistics, the barriers) fits an H100 block
    at every head dim, and the warps' partial sums fit in the ring."""
    src = SOURCE.read_text()
    c = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
         for k in ("TK", "WARPS", "ROWS", "MAX_SPLITS", "MAX_ROWS")}
    stages = int(re.search(r"static constexpr int STAGES = (\d+);", src).group(1))
    assert (c["TK"], c["ROWS"], c["MAX_SPLITS"]) == (da._ATTN_CHUNK, pa._CHUNK_ROWS,
                                                     da._ATTN_MAX_SPLITS)
    assert c["TK"] == 16 * c["WARPS"] and c["MAX_ROWS"] == 64
    for hd in (64, 128, 256):
        pitch = hd + 8
        ring = stages * 2 * c["TK"] * pitch * 2
        smem = ring + c["ROWS"] * pitch * 2 + 2 * c["WARPS"] * c["ROWS"] * 4 + 8 * stages
        assert smem <= 232448 and c["WARPS"] * c["ROWS"] * hd * 4 <= ring


def _inputs(B, C, H, KVH, hd, page, pps, lens, window, planted, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(torch.bfloat16)
    n_pages = B * pps + 3
    q, nk, nv = f(B, C, H, hd), f(B, C, KVH, hd), f(B, C, KVH, hd)
    kp, vp = f(n_pages, KVH, page, hd), f(n_pages, KVH, page, hd)
    tables = torch.from_numpy((rng.permutation(n_pages - 1)[:B * pps] + 1)
                              .reshape(B, pps).astype(np.int32))
    if planted:
        plant_paged_edges(q, kp, tables, lens, window)
    return q, nk, nv, kp, vp, torch.tensor(lens, dtype=torch.int32), tables


def _recording_entries(monkeypatch):
    """Replace the C entries by recording stand-ins; returns the record of
    (library, entry, arguments)."""
    calls = []

    def kernel(lib, fn, argtypes):
        return lambda *args: calls.append((lib, fn, args)) or 0

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(pa._build, "kernel", kernel)
    monkeypatch.setattr(pa._build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(pa, "_CHUNK_PLANS", {})
    return calls


def test_wrapper_hands_the_kernel_one_plan_whatever_the_batch(monkeypatch):
    """What ``paged_chunk_attention_cuda`` hands the split kernel's C entry,
    with recording stand-ins for the entries: the same (keys, splits) at B =
    1 and 8 and whatever the lengths, the shape and the window as given, one
    count a call in ``launches`` and ``split_launches``; a chunk of one token
    goes to the split kernel too, on the plan of C = 1."""
    calls = _recording_entries(monkeypatch)
    H, KVH, hd, page, pps, C = 8, 2, 64, 16, 8, 5
    launches, split = paged_chunk_attention_cuda.launches, paged_chunk_attention_cuda.split_launches
    cases = ((8, [0, 1, 15, 16, 17, 60, 100, 123]), (1, [123]), (1, [3]), (8, [7] * 8))
    for B, lens in cases:
        t = _inputs(B, C, H, KVH, hd, page, pps, lens, 12, False, B)
        paged_chunk_attention_cuda(*t, sm_scale=hd ** -0.5, sliding_window=12)
    t = _inputs(2, 1, H, KVH, hd, page, pps, [4, 9], 12, False, 1)
    paged_chunk_attention_cuda(*t, sm_scale=hd ** -0.5, sliding_window=12)
    plan = pa.paged_chunk_plan(page * pps, KVH, H // KVH, C, hd, 12)
    one = pa.paged_chunk_plan(page * pps, KVH, H // KVH, 1, hd, 12)
    for (lib, fn, args), (B, C_, p) in zip(calls, [(B, C, plan) for B, _ in cases] + [(2, 1, one)]):
        assert (lib, fn) == ("paged_attention_split", "paged_chunk_attention_split")
        assert args[9:16] == (B, C_, KVH, H // KVH, page, pps, hd)
        assert args[16] == pytest.approx(hd ** -0.5) and args[17:20] == (12, p.keys, p.splits)
    assert len(calls) == 5
    assert paged_chunk_attention_cuda.launches == launches + 5
    assert paged_chunk_attention_cuda.split_launches == split + 5


@pytest.mark.parametrize("window", [None, 12])
def test_decode_wrapper_hands_the_split_kernel_the_chunk_of_one(monkeypatch, window):
    """``paged_decode_attention_cuda`` at B = 1 and 8 hands the split
    kernel's C entry the chunk of one token: its q, new_k and new_v with a
    chunk axis of 1, the plan of C = 1 whatever the batch and the lengths, a
    workspace for that plan; one count a call in ``launches`` and
    ``split_launches``.  ``paged_attention.cu``'s decode entry is reached
    only through ``_paged_decode_before``, which counts nothing."""
    calls = _recording_entries(monkeypatch)
    H, KVH, hd, page, pps = 8, 2, 64, 16, 8
    n0 = (paged_decode_attention_cuda.launches, paged_decode_attention_cuda.split_launches)
    plan = pa.paged_chunk_plan(page * pps, KVH, H // KVH, 1, hd, window)
    for B, lens in ((8, [0, 1, 15, 16, 17, 60, 100, 126]), (1, [126]), (1, [3])):
        q, nk, nv, kp, vp, L, tables = _inputs(B, 1, H, KVH, hd, page, pps, lens, window, False,
                                               B)
        out, k, v = paged_decode_attention_cuda(q[:, 0], nk[:, 0], nv[:, 0], kp, vp, L, tables,
                                                sm_scale=hd ** -0.5, sliding_window=window)
        assert tuple(out.shape) == (B, H, hd) and k is kp and v is vp
        lib, fn, args = calls[-1]
        assert (lib, fn) == ("paged_attention_split", "paged_chunk_attention_split")
        assert args[9:16] == (B, 1, KVH, H // KVH, page, pps, hd)
        assert args[17:20] == (window or 0, plan.keys, plan.splits)
        assert args[3] == kp.data_ptr() and args[4] == vp.data_ptr()
    assert len(calls) == 3
    assert (paged_decode_attention_cuda.launches,
            paged_decode_attention_cuda.split_launches) == (n0[0] + 3, n0[1] + 3)
    pa._paged_decode_before(q[:, 0], nk[:, 0], nv[:, 0], kp, vp, L, tables,
                            sm_scale=hd ** -0.5, sliding_window=window)
    assert calls[-1][:2] == ("paged_attention", "paged_decode_attention")
    assert paged_decode_attention_cuda.launches == n0[0] + 3


def _emulate(q, nk, nv, kp, vp, lens, tables, sm_scale, window):
    """The split kernel's arithmetic, written out, for each (sequence, kv
    head, CTA row of 16 query rows): per split, chunks of 64 keys read
    through the page table; warp w takes keys 16 w .. 16 w + 15 of a chunk
    (none past the split: it skips the chunk); each (row, key) pair masked
    on its own (probability exactly 0); an online softmax in f32 with the
    probabilities rounded to bf16 for the value product; the warps merged in
    warp order, the splits in split order; then the chunk's own keys in f32
    and the den == 0 -> 1 guard."""
    B, C, H, hd = q.shape
    KVH, page = kp.shape[1], kp.shape[2]
    pps = tables.shape[1]
    G, T = H // KVH, page * pps
    plan = pa.paged_chunk_plan(T, KVH, G, C, hd, window)
    f = lambda t: t.float().numpy()
    qf, nkf, nvf, kf, vf = f(q), f(nk), f(nv), f(kp), f(vp)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).float().numpy()
    sm = np.float32(sm_scale)
    out = np.zeros((B, C, H, hd), np.float32)
    for b in range(B):
        n = int(lens[b])
        keys = lambda a, z, src, h: src[[int(tables[b, t // page]) for t in range(a, z)], h,
                                        [t % page for t in range(a, z)]]
        for h in range(KVH):
            for t0 in range(0, C * G, 16):
                rr = list(range(t0, min(t0 + 16, C * G)))
                qs = np.stack([qf[b, r // G, h * G + r % G] for r in rr])
                first = np.array([_first_visible(n, r // G, window) for r in rr])
                parts = []
                for k0, k1 in plan.split_keys(n, T, window):
                    if k1 <= k0:
                        break
                    warps = [(np.full(len(rr), MASK, np.float32), np.zeros(len(rr), np.float32),
                              np.zeros((len(rr), hd), np.float32)) for _ in range(4)]
                    for c0 in range(k0, k1, 64):
                        for w in range(4):
                            a, z = c0 + 16 * w, min(c0 + 16 * w + 16, k1)
                            if a >= z:
                                continue
                            m, l, acc = warps[w]
                            vis = np.arange(a, z)[None, :] >= first[:, None]
                            s = (qs @ keys(a, z, kf, h).T).astype(np.float32) * sm
                            s = np.where(vis, s, MASK).astype(np.float32)
                            mn = np.maximum(m, s.max(1))
                            alpha = np.exp(m - mn)
                            p = np.where(vis, np.exp(s - mn[:, None]), 0).astype(np.float32)
                            warps[w] = (mn, l * alpha + p.sum(1),
                                        acc * alpha[:, None] + bf(p) @ keys(a, z, vf, h))
                    mc = np.max([m for m, _, _ in warps], axis=0)
                    sc = [np.exp(m - mc) for m, _, _ in warps]
                    parts.append((mc, sum(l * c for (_, l, _), c in zip(warps, sc)),
                                  sum(acc * c[:, None] for (_, _, acc), c in zip(warps, sc))))
                M = (np.max([m for m, _, _ in parts], axis=0) if parts
                     else np.full(len(rr), MASK, np.float32))
                num = np.zeros((len(rr), hd), np.float32)
                L = np.zeros(len(rr), np.float32)
                for m, l, acc in parts:                                 # split order
                    sc = np.exp(m - M)
                    num, L = num + acc * sc[:, None], L + l * sc
                for i, r in enumerate(rr):
                    c = r // G
                    js = [j for j in range(c + 1) if not window or c - j < window]
                    s = np.array([qs[i] @ nkf[b, j, h] for j in js], np.float32) * sm
                    mf = max(M[i], s.max())
                    alpha = np.exp(M[i] - mf)
                    p = np.exp(s - mf)
                    den = L[i] * alpha + p.sum()
                    o = num[i] * alpha + sum(pj * nvf[b, j, h] for pj, j in zip(p, js))
                    out[b, c, h * G + r % G] = o / (den if den != 0 else 1.0)
    return out


def _close(got, want, rtol=2e-2):
    d = np.abs(got - want)
    tol = rtol * np.abs(want).max(-1, keepdims=True)
    assert (d <= tol).all(), f"max excess {(d - tol).max()}"


@pytest.mark.parametrize("B,C,H,KVH,hd,page,pps,lens,window,planted", [
    (3, 4, 4, 2, 128, 16, 4, [60, 15, 0], None, False),     # length + C == T, mid-page, empty
    (3, 5, 8, 2, 64, 16, 4, [40, 22, 9], 12, True),         # window edges planted, G = 4
    (2, 5, 8, 2, 64, 16, 2, [29, 3], None, False),          # the append clamped
])
def test_split_merge_matches_plain_and_jax(B, C, H, KVH, hd, page, pps, lens, window, planted):
    """The emulated split kernel agrees with ``paged_chunk_plain`` and with
    the JAX package's kernel (interpret mode on the CPU) on the same bf16
    inputs, and the plain version's pools take the append as JAX's do."""
    q, nk, nv, kp, vp, L, tables = _inputs(B, C, H, KVH, hd, page, pps, lens, window, planted,
                                           page * C)
    got = _emulate(q, nk, nv, kp, vp, lens, tables, hd ** -0.5, window)
    k2, v2 = kp.clone(), vp.clone()
    ref, _, _ = paged_chunk_plain(q, nk, nv, k2, v2, L, tables, sm_scale=hd ** -0.5,
                                  sliding_window=window)
    j = [jnp.asarray(t.view(torch.uint16).numpy()).view(jnp.bfloat16) for t in (q, nk, nv, kp, vp)]
    jo, jk, jv = jchunk(*j, jnp.asarray(lens, jnp.int32), jnp.asarray(tables.numpy()),
                        sm_scale=hd ** -0.5, sliding_window=window)
    _close(got, ref.float().numpy())
    _close(got, np.asarray(jo, np.float32))
    for a, jt in ((k2, jk), (v2, jv)):
        np.testing.assert_array_equal(a.view(torch.uint16).numpy(), np.asarray(jt).view(np.uint16))


@pytest.mark.parametrize("B,H,KVH,hd,page,pps,lens,window,planted", [
    (3, 4, 4, 128, 16, 4, [63, 15, 0], None, False),      # the table's last slot, mid-page, empty
    (3, 8, 2, 64, 16, 4, [40, 22, 9], 12, True),          # window edges planted, G = 4
    (2, 8, 2, 64, 16, 2, [32, 3], None, False),           # the append clamped into the last page
])
def test_split_merge_at_one_token_matches_decode_plain_and_jax(B, H, KVH, hd, page, pps, lens,
                                                               window, planted):
    """The decode step on the split kernel: the emulated kernel at C = 1
    agrees with ``paged_decode_plain`` and the JAX decode kernel (interpret
    mode on the CPU) on the same bf16 inputs, and the plain version's pools
    take the append as JAX's do, the clamped one included (length = pps *
    page breaks the precondition: the row lands in the sequence's own last
    page)."""
    q, nk, nv, kp, vp, L, tables = _inputs(B, 1, H, KVH, hd, page, pps, lens, window, planted,
                                           page + B)
    got = _emulate(q, nk, nv, kp, vp, lens, tables, hd ** -0.5, window)[:, 0]
    k2, v2 = kp.clone(), vp.clone()
    ref, _, _ = paged_decode_plain(q[:, 0], nk[:, 0], nv[:, 0], k2, v2, L, tables,
                                   sm_scale=hd ** -0.5, sliding_window=window)
    j = [jnp.asarray(t.view(torch.uint16).numpy()).view(jnp.bfloat16)
         for t in (q[:, 0], nk[:, 0], nv[:, 0], kp, vp)]
    jo, jk, jv = jdecode(*j, jnp.asarray(lens, jnp.int32), jnp.asarray(tables.numpy()),
                         sm_scale=hd ** -0.5, sliding_window=window)
    _close(got, ref.float().numpy())
    _close(got, np.asarray(jo, np.float32))
    for a, jt in ((k2, jk), (v2, jv)):
        np.testing.assert_array_equal(a.view(torch.uint16).numpy(), np.asarray(jt).view(np.uint16))


def test_paged_sweep_and_mutant_edits_apply_to_the_source():
    """Every variant of ``decode_sweep.py``'s paged set and every paged mutant
    of ``tile_sweep.py`` finds the text it replaces in the kernel source,
    once."""
    from qlora_tpu_torch.ops import decode_sweep, tile_sweep

    text = SOURCE.read_text()
    for table in (decode_sweep.PAGED_VARIANTS, tile_sweep.PAGED_MUTANTS):
        for name, edits in table.items():
            for old, new in edits:
                assert text.count(old) == 1, (name, old)
                assert old != new
    assert tile_sweep.MUTANT_SETS["paged"][0] == SOURCE.name
