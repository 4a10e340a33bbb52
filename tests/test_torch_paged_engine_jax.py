"""The port's ``PagedBatcher`` against the JAX package's on the same weights
(the ``debug`` config, JAX params carried across), in these configurations:
optimistic admission over a pool that preempts, the same with
``decode_impl="w8a8"`` (every decode step's linears on the int8 codes the
w8a8 kernel decodes from the NF4 weights), speculative verify chunks of 4
drafts, the same over the per-column int8 tree (``decode_impl="int8"``:
verify chunks of 4 slots x 5 rows), and a sliding window whose pages are
evicted as sequences roll past them.

Every request runs to its budget (no eos), so without speculation the
schedule depends only on lengths: the engine steps, the preemptions and the
preemption log must be equal.  Tokens are compared up to the first
near-tie: a position whose top-2 logits, teacher-forced through the port's
plain forward, lie within ``MARGIN`` of each other (twice the logits' atol
against JAX, test_torch_model), where bf16 rounded in another order may
pick the other token.  Under speculation the steps and ``spec_chunks``
follow the tokens, so that test runs prompts without near-ties and pins
them with ``spec_tokens`` and ``spec_plain_dispatches``."""

import dataclasses

import jax
import numpy as np
import torch

from qlora_tpu.generate.paged import PagedBatcher as JPagedBatcher
from qlora_tpu.models import get_config as jget_config
from qlora_tpu.models import init_params as jinit_params

from qlora_tpu_torch.generate.paged import PagedBatcher
from qlora_tpu_torch.models import forward, get_config
from qlora_tpu_torch.ops import default_impl
from test_torch_convert import bridge

torch.set_num_threads(2)
MARGIN = 0.2


def _run(engine):
    """Step to the end; the step count and the counters the test pins."""
    steps = 0
    while engine.queue or engine.num_active:
        engine.step()
        steps += 1
    uids = [r.uid for r in engine._test_reqs]
    log = [(uids.index(uid), n) for uid, n in engine.preemption_log]
    return steps, engine.preemptions, log


def _both(traffic, window=None, buckets=(16,), **kw):
    jcfg, cfg = jget_config("debug"), get_config("debug")
    if window:
        jcfg = dataclasses.replace(jcfg, sliding_window=window)
        cfg = dataclasses.replace(cfg, sliding_window=window)
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
    params, _ = bridge(jparams, None, cfg)
    base = dict(page_size=8, max_pages_per_seq=8, prefill_buckets=buckets, eos_id=-1)
    engines = (JPagedBatcher(jparams, None, jcfg, **base, **kw),
               PagedBatcher(params, None, cfg, device="cpu", **base, **kw))
    for e in engines:
        e._test_reqs = [e.submit(p, max_new_tokens=n) for p, n in traffic]
    return params, cfg, engines


def _clear_prefix(params, cfg, prompt, generated, impls=(None,)):
    """How many generated tokens precede the first near-tie of the forward
    under any of ``impls`` (None: exact; "w8a8": the w8a8 route)."""
    ids = torch.tensor([list(prompt) + list(generated)])
    first = len(generated)
    for impl in impls:
        with torch.inference_mode(), default_impl(impl):
            logits = forward(params, None, ids, cfg)[0].float()
        top2 = logits[0, len(prompt) - 1:-1].topk(2, dim=-1).values
        ties = ((top2[:, 0] - top2[:, 1]) <= MARGIN).nonzero()
        first = min(first, int(ties[0]) if len(ties) else first)
    return first


def _compare_tokens(params, cfg, traffic, jreqs, reqs, impls=(None,)):
    """Tokens equal up to each request's first near-tie; True where no
    request met one."""
    clear = True
    for (prompt, n), jr, r in zip(traffic, jreqs, reqs):
        assert len(jr.generated) == len(r.generated) == n
        upto = _clear_prefix(params, cfg, prompt, jr.generated, impls)
        assert r.generated[:upto] == jr.generated[:upto], (prompt, upto)
        clear &= upto == n
    return clear


def test_optimistic_admission_with_preemption_matches_jax_engine():
    rng = np.random.default_rng(21)
    traffic = [(rng.integers(1, 64, size=10).tolist(), 28) for _ in range(4)]
    params, cfg, (jpb, pb) = _both(traffic, num_slots=4, n_pages=17, admission="optimistic")
    want, got = _run(jpb), _run(pb)
    assert got == want and want[1] > 0          # steps, preemptions, log; it preempted
    _compare_tokens(params, cfg, traffic, jpb._test_reqs, pb._test_reqs)


def test_w8a8_decode_with_preemption_matches_jax_engine():
    """``decode_impl="w8a8"`` over the same preempting pool: the decode steps
    run ``qmm_nf4_w8a8``'s plain version against the JAX engine's
    ``_qmm_pallas_w8a8`` (interpret mode), the prefills exact NF4 on both.
    Steps, preemptions and the log equal; tokens equal up to the first
    near-tie of the exact or the w8a8 forward (seed 5's traffic: one request
    has none, and 31 of its 112 tokens are compared; seed 21's has a near-tie
    at every request's first token)."""
    rng = np.random.default_rng(5)
    traffic = [(rng.integers(1, 64, size=10).tolist(), 28) for _ in range(4)]
    params, cfg, (jpb, pb) = _both(traffic, num_slots=4, n_pages=17, admission="optimistic",
                                   decode_impl="w8a8")
    want, got = _run(jpb), _run(pb)
    assert got == want and want[1] > 0          # steps, preemptions, log; it preempted
    _compare_tokens(params, cfg, traffic, jpb._test_reqs, pb._test_reqs, impls=(None, "w8a8"))
    assert pb._test_reqs[0].generated == jpb._test_reqs[0].generated


def test_speculative_chunks_match_jax_engine():
    """Prompts that repeat a 4-token phrase (drafts get accepted), whose
    greedy continuations have every top-2 margin above MARGIN: here the
    steps and the chunk count follow the tokens, and are pinned.  (On
    prompts with near-ties they can differ: the phrase-repeat traffic of
    ROADMAP queue C gave 8 against 9 steps, 21 against 23 chunks.)"""
    traffic = [([16, 31, 21, 16] * 2, 8), ([7, 41, 58, 31] * 3, 8),
               ([19, 5, 48, 10] * 3, 6), ([41, 37, 46, 50] * 2, 8)]
    params, cfg, (jpb, pb) = _both(traffic, num_slots=3, n_pages=64, spec_draft_len=4)
    want, got = _run(jpb), _run(pb)
    assert (pb.spec_tokens, pb.spec_plain_dispatches) == (jpb.spec_tokens,
                                                          jpb.spec_plain_dispatches)
    assert _compare_tokens(params, cfg, traffic, jpb._test_reqs, pb._test_reqs)
    assert got == want and pb.spec_chunks == jpb.spec_chunks
    assert pb.spec_tokens > pb.spec_chunks > 0      # some drafts were accepted


def test_int8_speculative_chunks_match_jax_engine():
    """``decode_impl="int8", spec_draft_len=4`` over 4 slots: every verify
    chunk's 20 rows and every decode step through ``qmm_i8_direct``'s plain
    version (on the card, the split-K kernel up to 64 rows) on the
    per-column int8 tree, against the JAX engine's ``_qmm_pallas_i8_direct``
    (interpret mode); the prefills exact NF4 on both.  Prompts that repeat a
    4-token phrase, whose continuations have every top-2 margin above MARGIN
    under the exact forward and under the int8 tree's: tokens, steps,
    ``spec_tokens`` and ``spec_chunks`` are pinned."""
    traffic = [([55, 35, 3, 49] * 3, 8), ([43, 34, 41, 17] * 3, 8),
               ([51, 37, 55, 35] * 3, 8), ([57, 59, 6, 12] * 3, 8)]
    params, cfg, (jpb, pb) = _both(traffic, num_slots=4, n_pages=64, spec_draft_len=4,
                                   decode_impl="int8")
    want, got = _run(jpb), _run(pb)
    for (prompt, n), r in zip(traffic, pb._test_reqs):
        assert _clear_prefix(pb.decode_params, cfg, prompt, r.generated, ("w8a8",)) == n
    assert _compare_tokens(params, cfg, traffic, jpb._test_reqs, pb._test_reqs)
    assert got == want
    assert (pb.spec_tokens, pb.spec_chunks) == (jpb.spec_tokens, jpb.spec_chunks)
    assert pb.spec_tokens > pb.spec_chunks > 0      # some drafts were accepted


def test_sliding_window_eviction_with_preemption_matches_jax_engine():
    """``sliding_window`` 8 over pages of 8, rolling eviction on: pages behind
    every row's window go back to the pool as the sequences grow, and a pool
    of 6 pages (5 usable) still preempts (seed 1's prompts of 12-19 tokens, 40
    new tokens each).  Steps, preemptions and the preemption log equal the
    JAX engine's; tokens up to the first near-tie of the windowed forward."""
    rng = np.random.default_rng(1)
    traffic = [(rng.integers(1, 64, size=int(n)).tolist(), 40)
               for n in rng.integers(5, 20, size=4)]
    params, cfg, (jpb, pb) = _both(traffic, window=8, buckets=(16, 32), num_slots=3,
                                   n_pages=6, admission="optimistic", rolling_eviction=True)
    want, got = _run(jpb), _run(pb)
    assert got == want and want[1] > 0          # steps, preemptions, log; it preempted
    assert max(len(p) for p, _ in traffic) + 40 > 5 * 8    # no row fits the pool unevicted
    _compare_tokens(params, cfg, traffic, jpb._test_reqs, pb._test_reqs)
