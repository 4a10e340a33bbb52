"""Port paged KV pool and ``PagedBatcher``.

* The pool's allocator, eviction and prefill scatter, and
  ``paged_cache_from_numpy``, against the JAX package's ``PagedPool``: the
  same allocations give the same tables and byte-equal pools.
* Teacher-forced decode steps and a 5-token verify chunk through
  ``forward(cache=paged)`` on the same pool, against the JAX package (its
  Pallas kernels in interpret mode) at the ``debug`` config: logits within
  atol 0.1 (bf16 activations rounded in other orders, see
  test_torch_model) and the argmax equal wherever the top-2 margin exceeds
  twice that.
* The batcher's invariants, as tests/test_paged_pool.py pins them for the
  JAX engine, on the port alone (its plain path on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qlora_tpu.generate.engine import prefill as jprefill
from qlora_tpu.generate.paged import PagedPool as JPagedPool
from qlora_tpu.models import forward as jforward
from qlora_tpu.models import get_config as jget_config
from qlora_tpu.models import init_params as jinit_params
from qlora_tpu.models.transformer import init_cache as jinit_cache

from qlora_tpu_torch.generate import generate
from qlora_tpu_torch.generate.paged import PagedBatcher, PagedPool, PoolExhausted
from qlora_tpu_torch.generate.sampler import SamplingParams
from qlora_tpu_torch.lora import LoraConfig
from qlora_tpu_torch.models import forward, get_config, init_params
from qlora_tpu_torch.models.config import ModelConfig
from qlora_tpu_torch.utils import paged_cache_from_numpy
from test_torch_convert import bridge, nonzero_lora

torch.set_num_threads(2)
ATOL = 0.1


def _bits(t):
    return t.view(torch.uint16).numpy()


def test_allocator_lifecycle_and_eviction():
    cfg = get_config("debug")
    pool = PagedPool(cfg, n_pages=16, page_size=4, max_pages_per_seq=8, device="cpu")
    assert pool.n_free == 15                     # page 0 reserved as scratch
    pool.allocate(1, 10)                         # 3 pages
    pool.allocate(2, 4)                          # 1 page
    assert pool.n_free == 11 and 0 not in pool.tables[1] + pool.tables[2]
    pool.extend(1, 13)
    assert len(pool.tables[1]) == 4
    with pytest.raises(MemoryError, match="max_pages_per_seq"):
        pool.extend(1, 8 * 4 + 1)
    # positions < 9 are behind the window: pages 0 and 1 of uid 1 (< 8) go
    assert pool.evict_before(1, 9) == 2 and pool.tables[1][:2] == [0, 0]
    assert pool.evict_before(1, 9) == 0 and pool.n_free == 12
    tab = pool.table_array([1, 2, 99])
    assert tab.dtype == torch.int32 and tab.shape == (3, 8) and (tab[2] == 0).all()
    pool.release(1)
    pool.release(2)
    assert pool.n_free == 15 and not pool.tables
    with pytest.raises(PoolExhausted):
        pool.allocate(3, 16 * 4 + 1)


def test_write_prefill_and_convert_match_jax():
    """The same allocations in both pools give the same tables; a prompt's
    KV scattered into its pages leaves byte-equal pools, and the JAX pool
    carried across with ``paged_cache_from_numpy`` equals the port's."""
    jcfg, cfg = jget_config("debug"), get_config("debug")
    L, KVH, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(0)
    jpool = JPagedPool(jcfg, n_pages=12, page_size=8, max_pages_per_seq=4)
    pool = PagedPool(cfg, n_pages=12, page_size=8, max_pages_per_seq=4, device="cpu")
    for uid, T in ((7, 13), (9, 8), (4, 3)):
        kv = [jnp.asarray(rng.normal(size=(L, KVH, T, hd)), jnp.bfloat16) for _ in range(2)]
        jpool.allocate(uid, T)
        pool.allocate(uid, T)
        jpool.write_prefill(uid, *kv)
        t = [torch.from_numpy(np.asarray(a).view(np.uint16).copy()).view(torch.bfloat16)
             for a in kv]
        pool.write_prefill(uid, *t)
    assert pool.tables == jpool.tables and pool.free == jpool.free
    uids, lens = [7, 9, 4], [13, 8, 3]
    np.testing.assert_array_equal(pool.table_array(uids).numpy(),
                                  np.asarray(jpool.table_array(uids)))
    jc = jpool.decode_cache(uids, lens)
    carried = paged_cache_from_numpy(
        {k: ([np.asarray(a) for a in v] if isinstance(v, list) else np.asarray(v))
         for k, v in jc.items()}, "cpu")
    mine = pool.decode_cache(uids, lens)
    for name in ("k_pages", "v_pages"):
        assert len(carried[name]) == L
        for a, b in zip(carried[name], mine[name]):
            np.testing.assert_array_equal(_bits(a), _bits(b))
    assert torch.equal(carried["tables"], mine["tables"])
    assert torch.equal(carried["length"], mine["length"])


@pytest.fixture(scope="module")
def model():
    jcfg = jget_config("debug")
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
    jlora, jlcfg = nonzero_lora(jcfg)
    cfg = get_config("debug")
    params, lora = bridge(jparams, jlora, cfg)
    return (jcfg, jparams, jlora, jlcfg), (cfg, params, lora,
                                           LoraConfig(r=jlcfg.r, alpha=jlcfg.alpha))


def _check_logits(tlog, jlog):
    ref = np.asarray(jlog, np.float32)
    got = tlog.float().numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    top2 = np.sort(ref, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * ATOL
    np.testing.assert_array_equal(got.argmax(-1)[clear], ref.argmax(-1)[clear])
    return ref.argmax(-1)


def test_paged_decode_and_verify_chunk_match_jax(model):
    """Two prompts (5 and 11 tokens, pages of 8) prefilled in JAX and
    scattered into its pool; the pool carried into the port; then 3
    teacher-forced decode steps and one 5-token verify chunk through both
    packages' paged forward."""
    (jcfg, jp, jl, jlc), (cfg, p, lo, lc) = model
    ids = np.array([[3, 17, 5, 9, 11, 0, 0, 0, 0, 0, 0],
                    [4, 7, 1, 8, 2, 6, 13, 21, 5, 3, 9]], np.int32)
    lengths = [5, 11]
    jlast, jc = jprefill(jp, jl, jnp.asarray(ids), jnp.asarray(lengths), jcfg, jlc,
                        cache=jinit_cache(jcfg, 2, ids.shape[1]))
    pool = JPagedPool(jcfg, n_pages=16, page_size=8, max_pages_per_seq=4)
    uids = [1, 2]
    for i, (uid, n) in enumerate(zip(uids, lengths)):
        pool.allocate(uid, n)
        pool.write_prefill(uid, jc["k"][:, i, :, :n], jc["v"][:, i, :, :n])
    jcache = pool.decode_cache(uids, lengths)
    tcache = paged_cache_from_numpy(
        {k: ([np.asarray(a) for a in v] if isinstance(v, list) else np.asarray(v))
         for k, v in jcache.items()}, "cpu")
    tok = np.asarray(jlast, np.float32).argmax(-1).astype(np.int32)[:, None]
    for _ in range(3):
        for uid, n in zip(uids, np.asarray(jcache["length"])):
            pool.extend(uid, int(n) + 1)
        tables = pool.table_array(uids)
        jcache = dict(jcache, tables=tables)
        tcache = dict(tcache, tables=torch.from_numpy(np.array(tables)))
        jlog, jcache = jforward(jp, jl, jnp.asarray(tok), jcfg, jlc, cache=jcache)
        tlog, tcache = forward(p, lo, torch.from_numpy(tok), cfg, lc, cache=tcache)
        np.testing.assert_array_equal(tcache["length"].numpy(), np.asarray(jcache["length"]))
        tok = _check_logits(tlog[:, 0], jlog[:, 0]).astype(np.int32)[:, None]
    # a verify chunk: the pending token then four drafts, one crossing a page
    chunk = np.concatenate([tok, np.array([[5, 9, 11, 2], [3, 9, 2, 7]], np.int32)], 1)
    for uid, n in zip(uids, np.asarray(jcache["length"])):
        pool.extend(uid, int(n) + chunk.shape[1])
    tables = pool.table_array(uids)
    jcache = dict(jcache, tables=tables)
    tcache = dict(tcache, tables=torch.from_numpy(np.array(tables)))
    jlog, jcache = jforward(jp, jl, jnp.asarray(chunk), jcfg, jlc, cache=jcache)
    tlog, tcache = forward(p, lo, torch.from_numpy(chunk), cfg, lc, cache=tcache)
    _check_logits(tlog, jlog)
    np.testing.assert_array_equal(tcache["length"].numpy(), np.asarray(jcache["length"]))


# ---------------------------------------------------------------------------
# the batcher on the port alone
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def debug_params():
    cfg = get_config("debug")
    return cfg, init_params(cfg, seed=0, device="cpu")


def _batcher(params, cfg, **kw):
    base = dict(num_slots=2, n_pages=64, page_size=8, max_pages_per_seq=8,
                prefill_buckets=(16,), eos_id=-1, device="cpu")
    return PagedBatcher(params, None, cfg, **{**base, **kw})


def _drain(pb, traffic, per_step=None):
    """Submit the traffic (all at once, or `per_step` per engine step), run
    to the end, check the pool is fully recycled; returns the requests."""
    reqs = []
    queue = list(traffic)
    if per_step is None:
        reqs = [pb.submit(p, max_new_tokens=n) for p, n in queue]
        pb.run_to_completion()
    else:
        while queue or pb.queue or pb.num_active:
            for _ in range(per_step):
                if queue:
                    prompt, n = queue.pop(0)
                    reqs.append(pb.submit(prompt, max_new_tokens=n))
            pb.step()
    assert pb.pool.n_free == pb.pool.n_pages - 1 and not pb.pool.tables
    return reqs


def _traffic(n, seed, vocab=64, lmax=14, nmax=12, nmin=2):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, size=rng.integers(2, lmax)).tolist(),
             int(rng.integers(nmin, nmax))) for _ in range(n)]


def test_batcher_independent_of_slots_and_order(debug_params):
    """Results do not depend on the slot count or the submission order, and
    the first token, which the prefill makes, equals ``generate()``'s."""
    cfg, params = debug_params
    p1, p2, p3 = [3, 17, 5, 9], [4, 7], [11, 2, 6]
    jobs = [("a", p1, 5), ("b", p2, 5), ("c", p3, 4)]

    def run(num_slots, order):
        pb = _batcher(params, cfg, num_slots=num_slots)
        reqs = _drain(pb, [(p, n) for _, p, n in order])
        return {name: r.generated for (name, _, _), r in zip(order, reqs)}

    concurrent = run(2, jobs)
    assert concurrent == run(1, jobs) == run(2, [jobs[2], jobs[0], jobs[1]])
    for name, prompt, n in jobs:
        first = generate(params, None, torch.tensor([prompt]), torch.tensor([len(prompt)]),
                         cfg, max_new_tokens=1, eos_id=-1, device="cpu")
        assert concurrent[name][0] == int(first[0, 0]) and len(concurrent[name]) == n


def test_long_prompt_is_cut_from_the_left(debug_params):
    cfg, params = debug_params
    prompt = [(i * 7) % cfg.vocab_size for i in range(25)]
    pb = _batcher(params, cfg)
    (r,) = _drain(pb, [(prompt, 4)])
    kept = prompt[-min(8 * 8 - 4, 16):]
    first = generate(params, None, torch.tensor([kept]), torch.tensor([len(kept)]), cfg,
                     max_new_tokens=1, eos_id=-1, device="cpu")
    assert len(r.generated) == 4 and r.generated[0] == int(first[0, 0])


def test_bursts_and_grouped_admission_match_single(debug_params):
    """steps_per_dispatch > 1 and admit_batch > 1 change the schedule, not
    the greedy tokens, under staggered traffic with eos retirement."""
    cfg, params = debug_params
    traffic = _traffic(10, seed=7, vocab=cfg.vocab_size, lmax=20, nmax=10, nmin=1)

    def run(**kw):
        pb = _batcher(params, cfg, num_slots=3, n_pages=32, max_pages_per_seq=6,
                      prefill_buckets=(8, 16, 32), eos_id=5, **kw)
        reqs = _drain(pb, traffic, per_step=2)
        for r, (_, n) in zip(reqs, traffic):
            assert r.done and len(r.generated) <= n
        return [r.generated for r in reqs]

    single = run()
    assert run(steps_per_dispatch=4) == single
    assert run(admit_batch=3) == single
    assert run(admit_batch=3, steps_per_dispatch=4) == single


def test_optimistic_admission_preempts_and_matches_reserved(debug_params):
    """An over-committed pool: optimistic admission runs more sequences at
    once, preempts, and gives the reserved run's tokens (a preempted
    request up to its eviction point, then the same count)."""
    cfg, params = debug_params
    rng = np.random.default_rng(21)
    traffic = [(rng.integers(1, 64, size=10).tolist(), 28) for _ in range(4)]

    def run(admission):
        pb = _batcher(params, cfg, num_slots=4, n_pages=17, admission=admission)
        reqs = [pb.submit(p, max_new_tokens=n) for p, n in traffic]
        peak = 0
        while pb.queue or pb.num_active:
            pb.step()
            peak = max(peak, pb.num_active)
        assert pb.pool.n_free == 16 and not pb.pool.tables
        assert all(r.done and len(r.generated) == 28 for r in reqs)
        log = {[r.uid for r in reqs].index(uid): g for uid, g in pb.preemption_log}
        return [r.generated for r in reqs], peak, pb.preemptions, log

    res, res_peak, res_pre, _ = run("reserved")
    opt, opt_peak, opt_pre, log = run("optimistic")
    assert res_pre == 0 and opt_pre > 0 and opt_peak > res_peak
    for i, (o, r) in enumerate(zip(opt, res)):
        g = log.get(i, len(r))
        assert o[:g] == r[:g] and len(o) == len(r)


def test_pool_too_small_for_one_sequence_raises(debug_params):
    cfg, params = debug_params
    pb = _batcher(params, cfg, num_slots=1, n_pages=4)
    pb.submit(list(range(1, 15)), max_new_tokens=40)
    with pytest.raises(MemoryError, match="too small for a single"):
        pb.run_to_completion()


def test_sliding_window_eviction_allows_long_generation():
    """7 usable pages of 4 tokens hold fewer than 3 + 30 tokens: only
    eviction of pages behind the window lets this finish, and it gives the
    tokens of a run with an ample pool and no eviction (eviction touches
    only keys the window masks)."""
    cfg = ModelConfig(arch="llama", vocab_size=256, hidden_size=128, intermediate_size=256,
                      num_layers=2, num_heads=2, num_kv_heads=2, sliding_window=8)
    params = init_params(cfg, seed=0, device="cpu")
    kw = dict(num_slots=1, page_size=4, max_pages_per_seq=16)
    pb = _batcher(params, cfg, n_pages=8, **kw)
    (r,) = _drain(pb, [([5, 9, 3], 30)])
    ref = _batcher(params, cfg, n_pages=32, rolling_eviction=False, **kw)
    (r2,) = _drain(ref, [([5, 9, 3], 30)])
    assert len(r.generated) == 30 and r.generated == r2.generated


def _spec_run(params, cfg, spec, traffic, return_engine=False, **kw):
    pb = _batcher(params, cfg, num_slots=3, spec_draft_len=spec, **kw)
    reqs = _drain(pb, traffic, per_step=2)
    out = [r.generated for r in reqs]
    return (out, pb) if return_engine else out


@pytest.mark.parametrize("spec,kw", [
    (3, {}),
    (2, dict(steps_per_dispatch=3)),
    (4, dict(steps_per_dispatch=2, eos_id=5, max_pages_per_seq=4)),   # eos, capacity fallback
])
def test_speculative_greedy_matches_plain(debug_params, spec, kw):
    """Greedy acceptance keeps only the model's own argmax: the verify
    chunks change the number of forwards, not the tokens."""
    cfg, params = debug_params
    traffic = _traffic(6, seed=3 + spec, nmax=20 if "eos_id" in kw else 12)
    base = {k: v for k, v in kw.items() if k != "steps_per_dispatch"}
    plain = _spec_run(params, cfg, 0, traffic, **base)
    spec_out, pb = _spec_run(params, cfg, spec, traffic, return_engine=True, **kw)
    assert spec_out == plain
    assert pb.spec_chunks > 0 and pb.spec_tokens >= pb.spec_chunks


def test_speculative_drafts_are_accepted_on_repetitive_prompts(debug_params):
    """A prompt that repeats a phrase gives drafts; whatever is accepted,
    every chunk retires at least one token and the output is greedy's."""
    cfg, params = debug_params
    phrase = [7, 3, 9, 4, 11, 2]
    traffic = [(phrase * 3, 10), (phrase[::-1] * 2, 8)]
    plain = _spec_run(params, cfg, 0, traffic)
    out, pb = _spec_run(params, cfg, 4, traffic, return_engine=True)
    assert out == plain and pb.spec_tokens >= pb.spec_chunks > 0


def test_speculative_rejection_sampled_completes(debug_params):
    cfg, params = debug_params
    traffic = _traffic(5, seed=11)
    sp = SamplingParams(do_sample=True, temperature=0.9, top_k=8)
    outs = _spec_run(params, cfg, 3, traffic, steps_per_dispatch=2, sparams=sp, seed=123)
    for gen, (_, n) in zip(outs, traffic):
        assert 0 < len(gen) <= n and all(0 <= t < cfg.vocab_size for t in gen)


def test_adaptive_speculation_demotes_and_keeps_greedy(debug_params):
    """break_even 100 demotes as soon as the window fills: plain dispatches
    for the holdoff, a probe after it, and the plain greedy tokens."""
    cfg, params = debug_params
    traffic = _traffic(8, seed=17, nmax=40)
    plain = _spec_run(params, cfg, 0, traffic)
    adapt, pb = _spec_run(params, cfg, 3, traffic, return_engine=True, spec_adaptive=True,
                          spec_break_even=100.0)
    assert adapt == plain
    assert pb.spec_plain_dispatches >= pb._spec_holdoff
    assert pb.spec_chunks > pb._spec_window_chunks
    stays, pb = _spec_run(params, cfg, 3, traffic, return_engine=True, spec_adaptive=True,
                          spec_break_even=0.0)
    assert stays == plain and pb.spec_plain_dispatches <= 1


@pytest.mark.parametrize("kw", [
    dict(decode_impl="int8"),
    dict(decode_impl="w8a8"),
    dict(prefill_impl="w8a8"),
    dict(decode_impl="int8", prefill_impl="w8a8", spec_draft_len=2),
])
def test_int8_impls_complete(debug_params, kw):
    cfg, params = debug_params
    traffic = _traffic(4, seed=13)
    reqs = _drain(_batcher(params, cfg, num_slots=3, **kw), traffic, per_step=2)
    for r, (_, n) in zip(reqs, traffic):
        assert r.done and len(r.generated) == n
        assert all(0 <= t < cfg.vocab_size for t in r.generated)


def test_engine_arguments(debug_params):
    cfg, params = debug_params
    # tensor-parallel serving decodes exact or on the chunk-local int8 tree, as JAX's
    with pytest.raises(NotImplementedError, match="decode_impl='w8a8' is single-card"):
        _batcher(params, cfg, tp_mesh=object(), decode_impl="w8a8")
    for bad in (dict(decode_impl="fp8"), dict(prefill_impl="int8"), dict(admission="greedy")):
        with pytest.raises(ValueError):
            _batcher(params, cfg, **bad)
    with pytest.raises(NotImplementedError, match="repetition_penalty"):
        _batcher(params, cfg, spec_draft_len=2,
                 sparams=SamplingParams(do_sample=True, repetition_penalty=1.2))
    with pytest.raises(ValueError, match="params live on"):
        _batcher(params, cfg, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _batcher(params, cfg, device=None)
