"""Group (diverse) beam search and contrastive search.

The reference's generation surface (GenerationArguments ``num_beams``,
``num_beam_groups``, ``diversity_penalty``, ``length_penalty`` and
``penalty_alpha``, via HF generate) with HF semantics, as the JAX package's
``qlora_tpu/generate/search.py``:

* group beam search: beams split into G groups selected in turn each step;
  later groups pay ``diversity_penalty`` × (times a token was chosen by
  earlier groups this step) on their log-probs (Hamming diversity).  Plain
  beam search is the case G = 1.
* contrastive search: each step the top-k candidates by probability are
  scored ``(1 − α)·p(tok) − α·max cos-sim(h_tok, earlier hidden states)``
  over the post-final-norm hidden states, and the best is taken.

The loops run on the host, one forward a step, like ``decode_loop``; the
caches are updated in place.  Ties are broken as ``jax.lax.top_k`` breaks
them (the lower flat index first) by a stable descending sort, since
``torch.topk`` promises no order among equal values: at the first step the
dead beams all score ``NEG`` exactly.
"""

from __future__ import annotations

import torch

from qlora_tpu_torch.lora import LoraConfig
from qlora_tpu_torch.models.transformer import forward, init_cache

NEG = -1e30


def _top_k(x: torch.Tensor, n: int):
    """(values, indices) of the n largest of x along the last axis, equal
    values in index order (``jax.lax.top_k``'s order)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :n], indices[..., :n]


# ---------------------------------------------------------------------------
# copy-on-write paged KV for beam search
# ---------------------------------------------------------------------------
#
# The contiguous beam cache gathers the whole [B·k, KVH, T, hd] K/V of every
# layer on every step.  The paged form keeps the K/V in pages with a page
# table per beam:
#   * a row's full prompt pages are written once and shared by its k beams
#     (never written again: beams only append);
#   * completed generated pages never change, so a reorder gathers the
#     page-table rows;
#   * only the current partial page is copied (copy-on-write), page_size
#     tokens a beam instead of the whole context.
# Page ids are fixed (all beams of a row sit at the same position):
#   page 0                      padding entries
#   1 .. B·PB                   shared prompt pages, row-major
#   W0 + r·W .. W0 + (r+1)·W    the working pages of beam slot r


def _paged_beam_setup(params, lora, ids, lengths, cfg, lcfg, k, T, ps):
    """Prefill into a contiguous cache padded to ``Sp = ceil(S/ps)·ps``, then
    build the shared-prompt paged cache for B·k beam slots.  Returns
    (first logits [B·k, V], cache, W0, W)."""
    from qlora_tpu_torch.generate.engine import prefill

    B, S = ids.shape
    Sp = -(-S // ps) * ps
    if Sp > S:
        ids = torch.nn.functional.pad(ids, (0, Sp - S))
    cache = init_cache(cfg, B, Sp, device=ids.device)
    last, cache = prefill(params, lora, ids, lengths, cfg, lcfg, cache=cache)
    cache, w0, w = _build_paged_beam_cache(cache["k"], cache["v"], lengths, k, T, ps)
    return last.repeat_interleave(k, 0), cache, w0, w


def _build_paged_beam_cache(k_bufs, v_bufs, lengths, k, T, ps):
    """Pool and page tables from the prefilled contiguous K/V, per layer
    [B, KVH, Sp, hd].  Page plumbing only (no model).  Returns (cache, W0,
    W): per-layer pools [n_pages, KVH, ps, hd], tables [B·k, PB + W] int32,
    lengths and each slot's first own block ``fb``."""
    B, KVH, Sp, hd = k_bufs[0].shape
    dev = k_bufs[0].device
    PB = Sp // ps
    R = B * k
    W = (T + ps - 1) // ps + 1          # working blocks: the prompt remainder + generated
    W0 = 1 + B * PB
    n_pages = W0 + R * W
    lengths = lengths.to(device=dev, dtype=torch.int64)
    fb = lengths // ps                                      # [B]
    # each beam's first working page starts as the prompt remainder
    # (positions fb·ps .. length-1; the clamped filler past the length is
    # masked by the kernels and never attended)
    idx = torch.clamp(fb[:, None] * ps + torch.arange(ps, device=dev)[None, :], max=Sp - 1)
    wp0 = W0 + torch.arange(R, device=dev) * W

    def pool(buf):
        pages = buf.new_zeros((n_pages, KVH, ps, hd))
        pages[1:W0] = buf.reshape(B, KVH, PB, ps, hd).transpose(1, 2).reshape(
            B * PB, KVH, ps, hd)
        tail = torch.gather(buf, 2, idx[:, None, :, None].expand(B, KVH, ps, hd))
        pages[wp0] = tail.repeat_interleave(k, 0)
        return pages

    # tables [R, PB + W]: shared prompt pages below fb, the slot's own
    # working pages for the next W blocks, padding (page 0) beyond
    rows = torch.arange(R, device=dev)[:, None]
    fb_r = fb.repeat_interleave(k)
    blocks = torch.arange(PB + W, device=dev)[None, :]
    shared = 1 + (rows // k) * PB + blocks
    own = W0 + rows * W + (blocks - fb_r[:, None])
    tables = torch.where(blocks < fb_r[:, None], shared,
                         torch.where(blocks < (fb_r + W)[:, None], own, 0)).to(torch.int32)
    cache = {"k_pages": [pool(x) for x in k_bufs], "v_pages": [pool(x) for x in v_bufs],
             "tables": tables, "length": lengths.repeat_interleave(k).to(torch.int32),
             "fb": fb_r}
    return cache, W0, W


def _reorder_beams(cache, gather_rows, paged_w0, paged_w):
    """Reorder the beams' K/V for the selected sources (gather_rows [B·k]).

    Contiguous cache: gather whole rows into new buffers.  Paged cache:
    gather the page-table rows, copy each slot's current partial page from
    its source into its own page (every source is read before any page is
    written: a source may be another slot's own page that this step
    overwrites), and point the blocks from the current one on at the slot's
    own working pages, so that later appends never meet."""
    if paged_w0 is None:
        return {"k": [x[gather_rows] for x in cache["k"]],
                "v": [x[gather_rows] for x in cache["v"]],
                "length": cache["length"][gather_rows]}
    tables = cache["tables"][gather_rows]
    fb = cache["fb"]                     # the same within a row: no gather
    R, MP = tables.shape
    ps = cache["k_pages"][0].shape[2]
    c = cache["length"].long() // ps     # each slot's current (partial) block
    rows = torch.arange(R, device=tables.device)
    own_cur = paged_w0 + rows * paged_w + (c - fb)
    src_cur = tables.gather(1, c[:, None])[:, 0].long()
    for x in (*cache["k_pages"], *cache["v_pages"]):
        x.index_copy_(0, own_cur, x.index_select(0, src_cur))
    blocks = torch.arange(MP, device=tables.device)[None, :]
    own = paged_w0 + rows[:, None] * paged_w + (blocks - fb[:, None])
    mine = (blocks >= c[:, None]) & (blocks < (fb + paged_w)[:, None])
    return dict(cache, tables=torch.where(mine, own, tables).to(torch.int32))


# ---------------------------------------------------------------------------
# group (diverse) beam search
# ---------------------------------------------------------------------------


def _group_beam_loop(params, lora, first_logits, cache, *, cfg, lcfg, max_new_tokens, eos_id,
                     num_beams, num_beam_groups, diversity_penalty, length_penalty,
                     paged_w0=None, paged_w=None):
    """Diverse beam search with hypotheses finalized when they emit EOS.

    HF BeamSearchScorer semantics: each step takes 2·kg candidates a group;
    a candidate that emits EOS is finalized at once (its score normalized
    then and banked), and the kg continuing beams are refilled from the
    non-EOS candidates, so finished beams never stay in the live set.  A
    group is done when its best banked hypothesis can no longer be beaten by
    a live beam (HF's non-early-stopping test).  Divergence from HF, as in
    the JAX package: the normalization base is the GENERATED length (t + 1
    tokens, the EOS included), not HF's prompt + generated length; with a
    shared prompt length this is a monotone transform at a fixed t, but it
    weighs ``length_penalty`` != 1.0 slightly differently."""
    Bk, V = first_logits.shape
    dev = first_logits.device
    k, G, T = num_beams, num_beam_groups, max_new_tokens
    B, kg = Bk // k, num_beams // num_beam_groups
    n_cand = min(2 * kg, kg * V)         # >= kg non-EOS survive (<= kg can be EOS)
    rows = torch.arange(B, device=dev)
    lp = float(length_penalty)

    out = torch.full((B, k, T), eos_id, dtype=torch.int32, device=dev)
    # one live beam a group at t = 0 (every group starts from the same prefix)
    scores = torch.full((B, k), NEG, dtype=torch.float32, device=dev)
    scores[:, ::kg] = 0.0
    gdone = torch.zeros((B, G), dtype=torch.bool, device=dev)
    fin_sc = torch.full((B, G), float("-inf"), dtype=torch.float32, device=dev)
    fin_out = torch.full((B, G, T), eos_id, dtype=torch.int32, device=dev)
    logits = first_logits
    t = 0
    while t < T and not bool(gdone.all()):
        logp_all = torch.log_softmax(logits.float(), dim=-1).reshape(B, k, V)
        tf = torch.tensor(t + 1, dtype=torch.float32, device=dev)   # generated length incl. eos
        counts = torch.zeros((B, V), dtype=torch.float32, device=dev)
        toks = torch.zeros((B, k), dtype=torch.int64, device=dev)
        srcs = torch.zeros((B, k), dtype=torch.int64, device=dev)
        new_scores = torch.zeros((B, k), dtype=torch.float32, device=dev)
        for g in range(G):                # groups in order
            sl = slice(g * kg, (g + 1) * kg)
            lpg = logp_all[:, sl]
            if diversity_penalty > 0.0 and g > 0:
                lpg = lpg - diversity_penalty * counts[:, None, :]
            total = scores[:, sl, None] + lpg                       # [B, kg, V]
            sc2, idx2 = _top_k(total.reshape(B, kg * V), n_cand)
            src2 = g * kg + idx2 // V     # beams stay inside their group
            tok2 = idx2 % V
            is_eos = tok2 == eos_id

            # bank the best EOS candidate of this step (a running maximum over
            # the steps: the best finished hypothesis a group); a done group
            # banks no more, as HF's `if beam_hyps.is_done`
            cand = torch.where(is_eos, sc2 / tf ** lp, float("-inf"))
            bc = cand.argmax(1)                                     # [B]
            bsc = torch.where(gdone[:, g], float("-inf"), cand[rows, bc])
            cand_out = out[rows, src2[rows, bc]].clone()
            cand_out[:, t] = eos_id
            better = bsc > fin_sc[:, g]
            fin_out[:, g] = torch.where(better[:, None], cand_out, fin_out[:, g])
            fin_sc[:, g] = torch.where(better, bsc, fin_sc[:, g])

            # the continuing beams: the best kg non-EOS candidates
            sc_g, pick = _top_k(torch.where(is_eos, NEG, sc2), kg)  # [B, kg]
            tok_g = tok2.gather(1, pick)
            counts.scatter_add_(1, tok_g, torch.ones_like(sc_g))
            toks[:, sl] = tok_g
            srcs[:, sl] = src2.gather(1, pick)
            new_scores[:, sl] = sc_g

            # done test: live scores only fall and (length_penalty >= 0) the
            # normalizer only grows, so the best attainable hypothesis is
            # max(live) / tf^lp (T^lp for a negative penalty)
            norm = tf ** lp if lp >= 0.0 else torch.tensor(float(T), device=dev) ** lp
            gdone[:, g] |= fin_sc[:, g] >= sc_g.max(1).values / norm

        gather_rows = (rows[:, None] * k + srcs).reshape(-1)
        cache = _reorder_beams(cache, gather_rows, paged_w0, paged_w)
        out = out[rows[:, None], srcs]
        out[:, :, t] = toks.to(torch.int32)
        scores = new_scores
        logits, cache = forward(params, lora, toks.reshape(-1)[:, None], cfg, lcfg, cache=cache)
        logits = logits[:, 0]
        t += 1

    # a group with no finished hypothesis falls back to its best live beam,
    # normalized by its generated length
    gen_len = (out != eos_id).sum(-1).float() + 1.0
    norm = (scores / gen_len ** lp).reshape(B, G, kg)
    live_sc, live_best = norm.max(2)                                # [B, G]
    live_out = out.reshape(B, G, kg, T)[rows[:, None], torch.arange(G, device=dev)[None, :],
                                        live_best]                  # [B, G, T]
    use_fin = fin_sc > live_sc
    g_sc = torch.where(use_fin, fin_sc, live_sc)
    g_out = torch.where(use_fin[..., None], fin_out, live_out)
    return g_out[rows, g_sc.argmax(1)]


def group_beam_search(params, lora, ids, lengths, cfg, lcfg=LoraConfig(), *,
                      max_new_tokens=256, eos_id=2, num_beams=4, num_beam_groups=2,
                      diversity_penalty: float = 0.0, length_penalty: float = 1.0,
                      max_len=None, paged_kv: bool = True, page_size: int = 16,
                      device=None) -> torch.Tensor:
    """Diverse beam search (HF ``num_beam_groups`` semantics): the best
    hypothesis a row, tokens [B, max_new_tokens] int32, eos-padded.

    ``paged_kv=True`` (the default) runs the beams on the copy-on-write
    paged K/V (prompt pages shared by a row's beams; a reorder moves
    page-table rows and one partial page a beam) through the paged decode
    kernel; ``paged_kv=False`` keeps the contiguous cache and the decode
    attention kernel.  Runs on CUDA unless `device` names another device."""
    from qlora_tpu_torch.generate.engine import _inputs_on, prefill

    if num_beams % num_beam_groups != 0:
        raise ValueError("num_beams must be divisible by num_beam_groups")
    ids, lengths = _inputs_on(params, ids, lengths, device)
    B, S = ids.shape
    k = num_beams
    with torch.inference_mode():
        if paged_kv:
            first, cache, w0, w = _paged_beam_setup(params, lora, ids, lengths, cfg, lcfg, k,
                                                    max_new_tokens, page_size)
        else:
            cache = init_cache(cfg, B, max_len or (S + max_new_tokens), device=ids.device)
            last, cache = prefill(params, lora, ids, lengths, cfg, lcfg, cache=cache)
            cache = {"k": [x.repeat_interleave(k, 0) for x in cache["k"]],
                     "v": [x.repeat_interleave(k, 0) for x in cache["v"]],
                     "length": cache["length"].repeat_interleave(k)}
            first, w0, w = last.repeat_interleave(k, 0), None, None
        return _group_beam_loop(
            params, lora, first, cache, cfg=cfg, lcfg=lcfg, max_new_tokens=max_new_tokens,
            eos_id=eos_id, num_beams=k, num_beam_groups=num_beam_groups,
            diversity_penalty=float(diversity_penalty), length_penalty=float(length_penalty),
            paged_w0=w0, paged_w=w)


# ---------------------------------------------------------------------------
# contrastive search
# ---------------------------------------------------------------------------


def _unit(h: torch.Tensor) -> torch.Tensor:
    """Rows of h (f32) over their norms, the norms floored at 1e-6."""
    return h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True), min=1e-6)


def _degeneration_scores(p_c, hn, hist, n_hist, alpha):
    """Each candidate's ``(1 − α)·p − α·max cos-sim`` against the history:
    p_c [B, k] probabilities, hn [B, k, D] unit hidden states, hist
    [B, Tmax, D] unit rows of which the first n_hist[b] are valid."""
    sim = torch.einsum("bkd,btd->bkt", hn, hist)
    valid = torch.arange(hist.shape[1], device=hist.device)[None, None, :] < n_hist[:, None, None]
    max_sim = torch.where(valid, sim, -1.0).max(-1).values            # [B, k]
    return (1.0 - alpha) * p_c - alpha * max_sim


def _contrastive_loop(params, lora, first_logits, cache, hist, hist_len, *, cfg, lcfg,
                      max_new_tokens, eos_id, top_k, penalty_alpha):
    B, V = first_logits.shape
    dev = first_logits.device
    k, D = top_k, hist.shape[-1]
    alpha = float(penalty_alpha)
    rows = torch.arange(B, device=dev)
    out = torch.full((B, max_new_tokens), eos_id, dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    logits = first_logits
    t = 0
    while t < max_new_tokens and not bool(done.all()):
        probs = torch.softmax(logits.float(), dim=-1)
        p_c, tok_c = _top_k(probs, k)                               # [B, k]
        # the k candidates against k copies of the cache: fresh buffers, since
        # the decode kernel appends into the buffers it is given
        cache_x = {"k": [x.repeat_interleave(k, 0) for x in cache["k"]],
                   "v": [x.repeat_interleave(k, 0) for x in cache["v"]],
                   "length": cache["length"].repeat_interleave(k)}
        lg, cache_x, h = forward(params, lora, tok_c.reshape(-1)[:, None], cfg, lcfg,
                                 cache=cache_x, return_hidden=True)
        hn = _unit(h[:, 0].float().reshape(B, k, D))

        n_hist = hist_len + t                                       # prompt + generated
        best = _degeneration_scores(p_c, hn, hist, n_hist, alpha).argmax(1)   # [B]
        keep = rows * k + best
        tok = torch.where(done, eos_id, tok_c[rows, best])
        cache = {"k": [x[keep] for x in cache_x["k"]], "v": [x[keep] for x in cache_x["v"]],
                 "length": cache_x["length"][keep]}
        hist[rows, n_hist.long()] = hn[rows, best]
        out[:, t] = tok.to(torch.int32)
        done |= tok == eos_id
        logits = lg[:, 0].reshape(B, k, V)[rows, best]
        t += 1
    return out


def contrastive_search(params, lora, ids, lengths, cfg, lcfg=LoraConfig(), *,
                       max_new_tokens=256, eos_id=2, top_k=4, penalty_alpha=0.6, max_len=None,
                       device=None) -> torch.Tensor:
    """HF contrastive search (``penalty_alpha`` and ``top_k``): tokens
    [B, max_new_tokens] int32, eos-padded.  Runs on CUDA unless `device`
    names another device."""
    from qlora_tpu_torch.generate.engine import _inputs_on

    ids, lengths = _inputs_on(params, ids, lengths, device)
    B, S = ids.shape
    max_len = max_len or (S + max_new_tokens)
    with torch.inference_mode():
        cache = init_cache(cfg, B, max_len, device=ids.device)
        positions = torch.arange(S, device=ids.device)[None, :].repeat(B, 1)
        logits, cache, h = forward(params, lora, ids, cfg, lcfg, cache=cache,
                                   positions=positions, return_hidden=True)
        cache = dict(cache, length=lengths)
        last = logits[torch.arange(B, device=ids.device), lengths.long() - 1]
        # the history of unit hidden states (prompt rows past a length are
        # masked by the running count, which starts at the prompt's length)
        hist = torch.zeros((B, max_len + max_new_tokens, h.shape[-1]), dtype=torch.float32,
                           device=ids.device)
        hist[:, :S] = _unit(h.float())
        return _contrastive_loop(params, lora, last, cache, hist, lengths, cfg=cfg, lcfg=lcfg,
                                 max_new_tokens=max_new_tokens, eos_id=eos_id,
                                 top_k=int(top_k), penalty_alpha=float(penalty_alpha))
