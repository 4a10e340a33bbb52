"""The port's beam, group-beam and contrastive search (``generate/search.py``)
against the JAX package's, and counterparts of tests/test_search.py.

* ``forward(return_hidden=True)``: the post-final-norm hidden states within
  HIDDEN_ATOL of JAX's (bf16 activations rounded in other orders, as the
  logits' ATOL in test_torch_model); logits and cache as without it.
* The copy-on-write page plumbing (``_build_paged_beam_cache``,
  ``_reorder_beams``) is integer indexing and copies: pools, tables and
  lengths equal JAX's byte for byte after every reorder.
* Tokens: the debug models' weights carried across from JAX; the outputs
  equal JAX's exactly.  A beam search decides among 2·kg candidates a group
  a step, and at these models' bf16 logits some deciding margins (the
  kg-th against the (kg+1)-th candidate score) are exact ties or a bf16
  ulp: no prompt has them all clear.  The two packages' logits agree
  within 0.03 here (a fifth to three quarters bit for bit) and equal
  values break by index in both, so the outputs agree in full; a change of
  rounding on either side may move a near-tie, and this test then names
  the case to look at.  chip_smoke.py's search phase compares the card
  with the CPU step by step up to the first decision within the measured
  rounding instead.
* Tie order: ``jax.lax.top_k`` takes the lower flat index first among
  equal values, which the port's stable sort reproduces (``torch.topk``
  does not); a model with a vocabulary smaller than the candidates a
  group takes makes the dead beams' equal scores decide group 2's
  diversity penalty.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qlora_tpu.generate.engine import beam_search as jbeam_search
from qlora_tpu.generate.search import _build_paged_beam_cache as j_build
from qlora_tpu.generate.search import _reorder_beams as j_reorder
from qlora_tpu.generate.search import contrastive_search as jcontrastive
from qlora_tpu.generate.search import group_beam_search as jgroup_beam
from qlora_tpu.models import forward as jforward
from qlora_tpu.models import get_config as jget_config
from qlora_tpu.models import init_params as jinit_params
from qlora_tpu.models.unstack import unstack_cache

import qlora_tpu_torch.generate.search as search
from qlora_tpu_torch.generate import (
    SamplingParams, beam_search, contrastive_search, generate, group_beam_search,
)
from qlora_tpu_torch.models import forward, get_config
from test_torch_convert import bridge, nonzero_lora

torch.set_num_threads(2)
ATOL = 0.1            # logits against JAX (test_torch_model)
HIDDEN_ATOL = 0.05    # post-norm hidden states (|h| ~ 1) against JAX: bf16 ulps of a few
LOGIT_TIE = 0.035     # the largest |logit| difference between the packages on the debug
                      # models (0.031 and 0.016: two bf16 ulps at |logit| 2-4), rounded up
SCORE_TIE = 1e-3      # contrastive: (1 - α)·p - α·cos; teacher-forced the two packages'
                      # scores differ by ~3e-6

IDS = np.array([[3, 17, 5, 9, 7], [11, 2, 6, 0, 0]], np.int32)   # uneven lengths
LENGTHS = np.array([5, 3], np.int32)


_MODELS = {}


def _model(arch):
    """(JAX config, JAX params, config, the same params in the port), made once."""
    if arch not in _MODELS:
        jcfg = jget_config(arch)
        jparams = jinit_params(jax.random.PRNGKey(0), jcfg, quantized=True)
        cfg = get_config(arch)
        _MODELS[arch] = (jcfg, jparams, cfg, bridge(jparams, None, cfg)[0])
    return _MODELS[arch]


@pytest.fixture(scope="module")
def debug():
    return _model("debug")


@pytest.mark.parametrize("arch", ["debug", "debug-neox"])
def test_forward_return_hidden_matches_jax(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg, quantized=True)
    jlora, jlcfg = nonzero_lora(jcfg)
    params, lora = bridge(jparams, jlora, cfg)
    from qlora_tpu_torch.lora import LoraConfig

    lcfg = LoraConfig(r=jlcfg.r, alpha=jlcfg.alpha)
    ids = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    jl, _, jh = jforward(jparams, jlora, jnp.asarray(ids), jcfg, jlcfg, return_hidden=True)
    with torch.inference_mode():
        lg, cache, h = forward(params, lora, torch.from_numpy(ids), cfg, lcfg,
                               return_hidden=True)
        plain, _ = forward(params, lora, torch.from_numpy(ids), cfg, lcfg)
    assert cache is None and h.shape == (2, 9, cfg.hidden_size) and h.dtype == torch.bfloat16
    assert torch.equal(lg, plain)
    np.testing.assert_allclose(h.float().numpy(), np.asarray(jh, np.float32), atol=HIDDEN_ATOL,
                               rtol=0)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl, np.float32), atol=ATOL, rtol=0)


def _pools(cache, key):
    return np.stack([x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
                     for x in cache[key]])


@pytest.mark.parametrize("ps,lengths,Sp", [(4, (9, 3, 12), 12), (16, (33, 17, 1), 48)])
def test_paged_plumbing_matches_jax_byte_for_byte(ps, lengths, Sp):
    """Build the pool from the same prefilled K/V, then reorder with sources
    that fan out and overlap their destinations (a slot's source is another
    slot's own page that this step overwrites), appending a token per slot
    a step as the decode kernel does: pools, tables and lengths equal JAX's
    after every step."""
    rng = np.random.default_rng(ps)
    L, KVH, hd, k, T = 2, 2, 4, 3, 2 * ps + 3
    B, R = len(lengths), len(lengths) * k
    kbuf = rng.normal(size=(L, B, KVH, Sp, hd)).astype(np.float32)
    vbuf = rng.normal(size=(L, B, KVH, Sp, hd)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    jc, jw0, jw = j_build(jnp.asarray(kbuf), jnp.asarray(vbuf), jnp.asarray(lens), k, T, ps)
    jc = unstack_cache(jc)
    tc, w0, w = search._build_paged_beam_cache(
        [torch.from_numpy(x) for x in kbuf], [torch.from_numpy(x) for x in vbuf],
        torch.from_numpy(lens), k, T, ps)
    assert (w0, w) == (jw0, jw)

    def same():
        for key in ("k_pages", "v_pages"):
            np.testing.assert_array_equal(_pools(tc, key), _pools(jc, key))
        np.testing.assert_array_equal(tc["tables"].numpy(), np.asarray(jc["tables"]))
        assert tc["tables"].dtype == torch.int32
        np.testing.assert_array_equal(tc["length"].numpy(), np.asarray(jc["length"]))
        np.testing.assert_array_equal(tc["fb"].numpy(), np.asarray(jc["fb"]))

    same()
    for t in range(T):
        srcs = rng.integers(0, k, size=(B, k))
        srcs[:, 0] = np.roll(np.arange(k), 1)[0]          # slot 0 reads slot k-1's page
        g = (np.arange(B)[:, None] * k + srcs).reshape(-1)
        jc = j_reorder(jc, jnp.asarray(g), jw0, jw)
        tc = search._reorder_beams(tc, torch.from_numpy(g), w0, w)
        same()
        # append one token a slot where its table points, on both sides
        new = rng.normal(size=(L, R, KVH, hd)).astype(np.float32)
        pos = np.asarray(jc["length"])
        page = np.asarray(jc["tables"])[np.arange(R), pos // ps]
        jc = dict(jc, length=jc["length"] + 1,
                  **{key: [x.at[page, :, pos % ps].set(jnp.asarray(new[l]))
                           for l, x in enumerate(jc[key])] for key in ("k_pages", "v_pages")})
        for key in ("k_pages", "v_pages"):
            for l, x in enumerate(tc[key]):
                x[torch.from_numpy(page).long(), :, torch.from_numpy(pos % ps).long()] = (
                    torch.from_numpy(new[l]))
        tc = dict(tc, length=tc["length"] + 1)
        same()


def test_paged_cow_reorder_reconstructs_contiguous_kv():
    """Counterpart of tests/test_search.py's: the shared prompt pages, the
    page-table gather, the partial-page copy-on-write and the re-pointed
    blocks rebuild bit for bit the K/V a contiguous beam cache would hold,
    across uneven prompt lengths and reorders that fan out."""
    rng = np.random.default_rng(0)
    L, B, KVH, hd, k, ps, T = 2, 2, 2, 4, 3, 2, 7
    lengths = np.array([5, 3])
    Sp, R = 6, B * k
    kbuf = rng.normal(size=(L, B, KVH, Sp, hd)).astype(np.float32)
    vbuf = rng.normal(size=(L, B, KVH, Sp, hd)).astype(np.float32)
    cache, W0, W = search._build_paged_beam_cache(
        [torch.from_numpy(x) for x in kbuf], [torch.from_numpy(x) for x in vbuf],
        torch.from_numpy(lengths), k, T, ps)
    ck = np.concatenate([np.repeat(kbuf.transpose(0, 1, 3, 2, 4), k, axis=1),
                         np.zeros((L, R, T, KVH, hd), np.float32)], axis=2)
    cv = np.concatenate([np.repeat(vbuf.transpose(0, 1, 3, 2, 4), k, axis=1),
                         np.zeros((L, R, T, KVH, hd), np.float32)], axis=2)
    clen = np.repeat(lengths, k)
    for t in range(T):
        g = (np.arange(B)[:, None] * k + rng.integers(0, k, size=(B, k))).reshape(-1)
        cache = search._reorder_beams(cache, torch.from_numpy(g), W0, W)
        ck, cv = ck[:, g], cv[:, g]
        k1 = rng.normal(size=(L, R, KVH, hd)).astype(np.float32)
        v1 = rng.normal(size=(L, R, KVH, hd)).astype(np.float32)
        pos = cache["length"].long()
        page = cache["tables"].gather(1, (pos // ps)[:, None])[:, 0].long()
        for l in range(L):
            cache["k_pages"][l][page, :, pos % ps] = torch.from_numpy(k1[l])
            cache["v_pages"][l][page, :, pos % ps] = torch.from_numpy(v1[l])
        cache = dict(cache, length=cache["length"] + 1)
        ck[np.arange(L)[:, None], np.arange(R)[None, :], clen] = k1
        cv[np.arange(L)[:, None], np.arange(R)[None, :], clen] = v1
        clen = clen + 1
        tb = cache["tables"].numpy()
        kpg, vpg = _pools(cache, "k_pages"), _pools(cache, "v_pages")
        for r in range(R):
            n = int(clen[r])
            for got, want in ((kpg, ck), (vpg, cv)):
                rebuilt = got[:, tb[r]].transpose(0, 2, 1, 3, 4).reshape(L, KVH, -1, hd)[:, :, :n]
                np.testing.assert_array_equal(rebuilt, want[:, r, :n].transpose(0, 2, 1, 3),
                                              err_msg=f"step {t} beam {r}")


def test_top_k_takes_jax_tie_order():
    rng = np.random.default_rng(1)
    x = rng.integers(-3, 3, size=(4, 40)).astype(np.float32)
    x[:, ::3] = np.float32(-1e30) + np.float32(-2.5)     # rounds to -1e30 exactly
    for n in (1, 5, 17, 40):
        jv, ji = jax.lax.top_k(jnp.asarray(x), n)
        v, i = search._top_k(torch.from_numpy(x), n)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_tie_order_at_t0_decides_diversity_like_jax():
    """Vocabulary 3, 4 beams in 2 groups: each group takes 4 candidates of
    which only 3 come from its live beam, so a dead beam's candidate (score
    NEG exactly) fills the last place; which one, by tie order, decides the
    token it counts against group 2 under the diversity penalty."""
    jcfg = dataclasses.replace(jget_config("debug"), vocab_size=3)
    cfg = dataclasses.replace(get_config("debug"), vocab_size=3)
    jparams = jinit_params(jax.random.PRNGKey(2), jcfg, quantized=True)
    params, _ = bridge(jparams, None, cfg)
    ids = np.array([[1, 2, 0, 1], [2, 2, 1, 0]], np.int32)
    lengths = np.array([4, 3], np.int32)
    kw = dict(num_beams=4, num_beam_groups=2, diversity_penalty=3.0, max_new_tokens=4,
              eos_id=-1, paged_kv=False)
    want = np.asarray(jgroup_beam(jparams, None, jnp.asarray(ids), jnp.asarray(lengths), jcfg,
                                  **kw))
    got = group_beam_search(params, None, ids, lengths, cfg, device="cpu", **kw).numpy()
    np.testing.assert_array_equal(got, want)


GROUP_CASES = {   # model, paged, groups, length_penalty
    "debug-paged-g1-lp1": ("debug", True, 1, 1.0),
    "debug-paged-g2-lp0.6": ("debug", True, 2, 0.6),
    "debug-paged-g1-lp-0.5": ("debug", True, 1, -0.5),
    "debug-contiguous-g1-lp1": ("debug", False, 1, 1.0),
    "debug-contiguous-g2-lp0.6": ("debug", False, 2, 0.6),
    "debug-contiguous-g2-lp-0.5": ("debug", False, 2, -0.5),
    "neox-paged-g1-lp1": ("debug-neox", True, 1, 1.0),
    "neox-paged-g2-lp0.6": ("debug-neox", True, 2, 0.6),
    "neox-contiguous-g2-lp-0.5": ("debug-neox", False, 2, -0.5),
}


@pytest.mark.parametrize("case", list(GROUP_CASES))
def test_group_beam_search_matches_jax(case):
    arch, paged, G, lp = GROUP_CASES[case]
    jcfg, jparams, cfg, params = _model(arch)
    kw = dict(num_beams=4, num_beam_groups=G, diversity_penalty=0.5, length_penalty=lp,
              max_new_tokens=6, eos_id=-1, paged_kv=paged, page_size=4)
    got = group_beam_search(params, None, IDS, LENGTHS, cfg, device="cpu", **kw).numpy()
    assert got.shape == (2, 6) and got.dtype == np.int32
    want = np.asarray(jgroup_beam(jparams, None, jnp.asarray(IDS), jnp.asarray(LENGTHS), jcfg,
                                  **kw))
    np.testing.assert_array_equal(got, want)


def _contrastive_margins(monkeypatch, V):
    """Record, per step and row, the port's deciding margins of contrastive
    search: the k-th against the (k+1)-th candidate's logit (which tokens
    are candidates) and the best against the second degeneration score."""
    steps = []
    real_top_k, real_scores = search._top_k, search._degeneration_scores

    def top_k(x, n):
        if x.shape[-1] == V:                          # the candidates by probability
            lp = torch.log(torch.sort(x, dim=-1, descending=True, stable=True).values)
            steps.append({"logit": (lp[:, n - 1] - lp[:, n]).numpy()})
        return real_top_k(x, n)

    def scores(*a):
        s = real_scores(*a)
        v = s.sort(-1, descending=True).values
        steps[-1]["score"] = (v[:, 0] - v[:, 1]).numpy()
        return s

    monkeypatch.setattr(search, "_top_k", top_k)
    monkeypatch.setattr(search, "_degeneration_scores", scores)
    return steps


@pytest.mark.parametrize("arch", ["debug", "debug-neox"])
def test_contrastive_search_matches_jax(arch, monkeypatch):
    """Tokens equal JAX's up to each row's first near-tie of the port's run:
    a step whose candidate boundary (k-th against (k+1)-th logit) is within
    LOGIT_TIE, or whose best two degeneration scores are within SCORE_TIE.
    On ``debug`` the whole output is equal; on ``debug-neox`` row 0's
    fifth candidate ties the fourth exactly at its third step (both logits
    2.21875), and JAX's cached loop takes the other one."""
    jcfg, jparams, cfg, params = _model(arch)
    kw = dict(top_k=4, penalty_alpha=0.6, max_new_tokens=8, eos_id=-1)
    steps = _contrastive_margins(monkeypatch, cfg.vocab_size)
    got = contrastive_search(params, None, IDS, LENGTHS, cfg, device="cpu", **kw).numpy()
    want = np.asarray(jcontrastive(jparams, None, jnp.asarray(IDS), jnp.asarray(LENGTHS), jcfg,
                                   **kw))
    assert got.shape == want.shape == (2, 8) and len(steps) == 8
    compared = 0
    for b in range(2):
        tied = [t for t, m in enumerate(steps)
                if m["logit"][b] <= LOGIT_TIE or m["score"][b] <= SCORE_TIE]
        upto = tied[0] + 1 if tied else 8       # the tied step's own choice may differ
        np.testing.assert_array_equal(got[b, :upto - (1 if tied else 0)],
                                      want[b, :upto - (1 if tied else 0)])
        compared += upto - (1 if tied else 0)
    assert compared >= 2
    if arch == "debug":
        np.testing.assert_array_equal(got, want)


def test_eos_finalization_matches_jax_and_python_reference(debug):
    """EOS-time finalization (HF BeamSearchScorer) against a brute-force
    Python reference over the port's forward (as tests/test_search.py does
    for JAX's), and against JAX's beam search: EOS candidates banked with
    the score normalized then, the continuing beams refilled from the
    non-EOS candidates, the loop stopped once the banked best is out of
    reach."""
    jcfg, jparams, cfg, params = debug
    k, T = 3, 6
    prompt, plen = IDS[:1], int(LENGTHS[0])
    greedy = generate(params, None, prompt, LENGTHS[:1], cfg, max_new_tokens=2, eos_id=-1,
                      device="cpu").numpy()
    eos = int(greedy[0, 1])      # hypotheses really finish early
    got = beam_search(params, None, prompt, LENGTHS[:1], cfg, num_beams=k, max_new_tokens=T,
                      eos_id=eos, device="cpu").numpy()[0]

    def logp_of(toks):
        full = torch.tensor([prompt[0, :plen].tolist() + toks])
        with torch.inference_mode():
            lg, _ = forward(params, None, full, cfg)
        return torch.log_softmax(lg[0, -1].float(), -1).numpy()

    live = [(np.float32(0.0), [])]
    fin_sc, fin_toks, t_final = -np.inf, None, T
    for t in range(T):
        cands = []
        for bi, (sc, toks) in enumerate(live):
            lp = logp_of(toks)
            cands += [(np.float32(sc + lp[v]), bi, v) for v in range(cfg.vocab_size)]
        cands.sort(key=lambda c: (-c[0], c[1] * cfg.vocab_size + c[2]))
        top = cands[:2 * k]
        tf = np.float32(t + 1)
        eos_top = [c for c in top if c[2] == eos]
        if eos_top:
            sc, bi, _ = eos_top[0]
            if sc / tf > fin_sc:
                fin_sc, fin_toks = sc / tf, live[bi][1] + [eos]
        live = [(sc, live[bi][1] + [v]) for sc, bi, v in top if v != eos][:k]
        if fin_sc >= max(sc for sc, _ in live) / tf:
            t_final = t + 1
            break
    best_sc, best_toks = max(live, key=lambda x: x[0])
    want = fin_toks if fin_sc > best_sc / np.float32(t_final + 1) else best_toks
    np.testing.assert_array_equal(got, np.asarray((want + [eos] * T)[:T], np.int32))
    jgot = np.asarray(jbeam_search(jparams, None, jnp.asarray(prompt), jnp.asarray(LENGTHS[:1]),
                                   jcfg, num_beams=k, max_new_tokens=T, eos_id=eos))[0]
    np.testing.assert_array_equal(got, jgot)


def test_single_group_equals_plain_beam_search(debug):
    _, _, cfg, params = debug
    kw = dict(num_beams=4, max_new_tokens=6, eos_id=-1, device="cpu")
    a = group_beam_search(params, None, IDS, LENGTHS, cfg, num_beam_groups=1, **kw)
    b = beam_search(params, None, IDS, LENGTHS, cfg, **kw)
    assert torch.equal(a, b)


def test_zero_diversity_groups_of_one_are_greedy(debug):
    """k groups of one beam and no penalty: every group follows the greedy
    continuation (contiguous cache: the same decode kernel as generate)."""
    _, _, cfg, params = debug
    greedy = generate(params, None, IDS, LENGTHS, cfg, max_new_tokens=6, eos_id=-1,
                      device="cpu")
    g = group_beam_search(params, None, IDS, LENGTHS, cfg, num_beams=3, num_beam_groups=3,
                          diversity_penalty=0.0, max_new_tokens=6, eos_id=-1, paged_kv=False,
                          device="cpu")
    assert torch.equal(g, greedy)


def test_diversity_penalty_changes_groups(debug):
    _, _, cfg, params = debug
    kw = dict(num_beams=4, num_beam_groups=2, max_new_tokens=6, eos_id=-1, device="cpu")
    base = group_beam_search(params, None, IDS, LENGTHS, cfg, diversity_penalty=0.0, **kw)
    div = group_beam_search(params, None, IDS, LENGTHS, cfg, diversity_penalty=100.0, **kw)
    assert div.shape == base.shape and ((div >= 0) & (div < cfg.vocab_size)).all()
    assert not torch.equal(div, base)


def test_beams_not_divisible_by_groups_raises(debug):
    _, _, cfg, params = debug
    with pytest.raises(ValueError, match="divisible"):
        group_beam_search(params, None, IDS, LENGTHS, cfg, num_beams=4, num_beam_groups=3,
                          max_new_tokens=4, device="cpu")


def test_contrastive_alpha0_equals_greedy(debug):
    _, _, cfg, params = debug
    greedy = generate(params, None, IDS, LENGTHS, cfg, max_new_tokens=6, eos_id=-1,
                      device="cpu")
    c = contrastive_search(params, None, IDS, LENGTHS, cfg, top_k=4, penalty_alpha=0.0,
                           max_new_tokens=6, eos_id=-1, device="cpu")
    assert torch.equal(c, greedy)


def test_contrastive_penalizes_degeneration(debug):
    """A repeating prompt: greedy decoding repeats it; a strong degeneration
    penalty leaves the tokens whose hidden states it has seen."""
    _, _, cfg, params = debug
    ids, lengths = np.array([[7, 3, 7, 3, 7, 3, 7, 3]], np.int32), np.array([8], np.int32)
    c = contrastive_search(params, None, ids, lengths, cfg, top_k=4, penalty_alpha=0.6,
                           max_new_tokens=8, eos_id=-1, device="cpu")
    assert c.shape == (1, 8) and ((c >= 0) & (c < cfg.vocab_size)).all()
    greedy = generate(params, None, ids, lengths, cfg, max_new_tokens=8, eos_id=-1,
                      device="cpu")
    strong = contrastive_search(params, None, ids, lengths, cfg, top_k=4, penalty_alpha=0.99,
                                max_new_tokens=8, eos_id=-1, device="cpu")
    assert not torch.equal(strong, greedy)


def test_eos_output_padded_after_first_eos(debug):
    _, _, cfg, params = debug
    greedy = generate(params, None, IDS, LENGTHS, cfg, max_new_tokens=3, eos_id=-1,
                      device="cpu").numpy()
    eos = int(greedy[0, 2])
    out = beam_search(params, None, IDS, LENGTHS, cfg, num_beams=4, max_new_tokens=8,
                      eos_id=eos, device="cpu").numpy()
    for row in out:
        pos = np.where(row == eos)[0]
        if pos.size:
            assert (row[pos[0]:] == eos).all()


def test_generate_dispatches_search_variants(debug, monkeypatch):
    """generate() reaches each search with the arguments the JAX package's
    passes: contrastive with top_k = max(sparams.top_k, 2), then groups,
    then beams (paged, page 16)."""
    _, _, cfg, params = debug
    calls = []
    for name in ("contrastive_search", "group_beam_search"):
        real = getattr(search, name)
        monkeypatch.setattr(search, name, lambda *a, _n=name, _r=real, **kw: (
            calls.append((_n, kw)), _r(*a, **kw))[1])
    kw = dict(max_new_tokens=4, eos_id=-1, device="cpu")
    g = generate(params, None, IDS, LENGTHS, cfg, num_beams=4, num_beam_groups=2,
                 diversity_penalty=1.0, length_penalty=0.7, **kw)
    c = generate(params, None, IDS, LENGTHS, cfg, penalty_alpha=0.6,
                 sparams=SamplingParams(top_k=0), **kw)
    b = generate(params, None, IDS, LENGTHS, cfg, num_beams=4, **kw)
    assert g.shape == c.shape == b.shape == (2, 4)
    (n1, k1), (n2, k2), (n3, k3) = calls
    assert n1 == "group_beam_search" and k1["num_beam_groups"] == 2
    assert (k1["diversity_penalty"], k1["length_penalty"]) == (1.0, 0.7)
    assert n2 == "contrastive_search" and k2["top_k"] == 2 and k2["penalty_alpha"] == 0.6
    assert n3 == "group_beam_search" and k3["num_beam_groups"] == 1 and k3["paged_kv"]
    assert k3["page_size"] == 16
    assert torch.equal(b, beam_search(params, None, IDS, LENGTHS, cfg, num_beams=4, **kw))


def test_paged_beams_run_with_uneven_prompt_lengths(debug):
    """Page sizes 2 and 4 read the same logical K/V: the same hypotheses,
    and those of the contiguous cache."""
    _, _, cfg, params = debug
    outs = [beam_search(params, None, IDS, LENGTHS, cfg, num_beams=4, max_new_tokens=6,
                        eos_id=-1, paged_kv=paged, page_size=ps, device="cpu")
            for paged, ps in ((True, 2), (True, 4), (False, 16))]
    assert ((outs[0] >= 0) & (outs[0] < cfg.vocab_size)).all()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def test_searches_refuse_decode_impl(debug):
    _, _, cfg, params = debug
    for kw in (dict(num_beams=2), dict(penalty_alpha=0.6), dict(num_beam_groups=2,
                                                                 num_beams=2)):
        with pytest.raises(NotImplementedError, match="exact bf16 path"):
            generate(params, None, IDS, LENGTHS, cfg, max_new_tokens=1, device="cpu",
                     decode_impl="int8", **kw)
