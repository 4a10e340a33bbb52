"""Tensor-parallel serving (qlora_tpu_torch.parallel, PagedBatcher(tp_mesh=...))
against the JAX package, in gloo worlds of 2 and 4 ranks on the CPU.

Each rank is a process (tests/torch_tp_worker.py) that takes the whole
params carried from JAX, cuts its shard (``shard_decode_params``: each
row-parallel linear its K-chunk quantized alone) and runs the port's tp path; one
world a rank count runs every case, since each start costs seconds.  JAX's
own tensor-parallel tests are marked slow for their ``shard_map`` compiles,
so the port is held against JAX's single-device ``forward`` on JAX's
``requantize_row_parallel`` tree at JAX's own bound (tests/test_tp_decode.py):
logits within atol 0.2, argmax equal at >= 90 % of positions.  The engines'
greedy tokens are held to the port's single-device batcher up to the first
position whose top-2 margin (teacher-forced, no cache) is under 0.4, twice
that bound, and every token they emit to the single device's teacher-forced
logits on the engine's own sequence: within 0.4 of the best there, whether
or not a near-tie came first."""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qlora_tpu.models import forward as jforward
from qlora_tpu.models import get_config as jget_config
from qlora_tpu.models import init_params as jinit_params
from qlora_tpu.models.config import ModelConfig as JModelConfig
from qlora_tpu.models.transformer import init_cache as jinit_cache
from qlora_tpu.parallel.megatron_step import requantize_row_parallel as jrequantize_rp

from qlora_tpu_torch.generate.paged import PagedBatcher
from qlora_tpu_torch.lora import LoraConfig
from qlora_tpu_torch.models import forward, get_config
from qlora_tpu_torch.models.config import ModelConfig
from qlora_tpu_torch.parallel import run_ranks
from test_torch_convert import bridge, jax_to_numpy, nonzero_lora
import torch_tp_worker

torch.set_num_threads(2)

# JAX's tensor-parallel test models (tests/test_tp_decode.py:18-27)
CFG = dict(arch="llama", vocab_size=512, hidden_size=512, intermediate_size=512,
           num_layers=2, num_heads=4, num_kv_heads=4)
GQA = dict(CFG, num_kv_heads=2)
ATOL, ARGMAX, TIE = 0.2, 0.9, 0.4
B, S, CAP, NSTEP = 2, 8, 32, 4


def _model(name):
    """(JAX cfg, port cfg, JAX params, JAX LoRA with nonzero B, port lcfg)."""
    if name == "debug-neox":
        jcfg, cfg = jget_config(name), get_config(name)
    else:
        jcfg, cfg = JModelConfig(**name), ModelConfig(**name)
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg, quantized=True)
    if jcfg.use_bias:
        # nonzero biases, so that the row-parallel bias (divided by tp on each
        # partial) shows
        rng = np.random.default_rng(5)
        blocks = {k: (v.replace(bias=jnp.asarray(rng.normal(size=v.bias.shape) * 0.1,
                                                 jnp.float32))
                      if getattr(v, "bias", None) is not None else v)
                  for k, v in jparams["blocks"].items()}
        jparams = dict(jparams, blocks=blocks)
    jlora, jlcfg = nonzero_lora(jcfg, seed=1, r=8)
    return jcfg, cfg, jparams, jlora, jlcfg, LoraConfig(r=jlcfg.r, alpha=jlcfg.alpha)


def _inputs(vocab, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (B, S)).astype(np.int64),
            rng.integers(0, vocab, (B, NSTEP)).astype(np.int64))


_jforward = jax.jit(jforward, static_argnums=(3, 4))


def _jax_forced(jcfg, jparams, jlora, jlcfg, tp, ids, forced):
    """JAX's single-device forward on its re-packed tree: the prefill's last
    logits, then each teacher-forced decode step's."""
    p = jrequantize_rp(jparams, tp)
    logits, cache = _jforward(p, jlora, jnp.asarray(ids, jnp.int32), jcfg, jlcfg,
                              cache=jinit_cache(jcfg, B, CAP))
    outs = [logits[:, S - 1]]
    for t in range(forced.shape[1]):
        logits, cache = _jforward(p, jlora, jnp.asarray(forced[:, t:t + 1], jnp.int32), jcfg,
                                  jlcfg, cache=cache)
        outs.append(logits[:, 0])
    return np.asarray(jnp.stack(outs, 1), np.float32)


FORWARDS = {"cfg": CFG, "gqa": GQA, "neox": "debug-neox"}


def _case(name, model, tp):
    jcfg, cfg, jparams, jlora, jlcfg, lcfg = model
    ids, forced = _inputs(cfg.vocab_size)
    kw = dict(cfg=cfg, lcfg=lcfg, params_np=jax_to_numpy(jparams), lora_np=jax_to_numpy(jlora),
              ids=ids, forced=forced)
    return (name, "forced_logits", dict(kw, cap=CAP)), _jax_forced(
        jcfg, jparams, jlora, jlcfg, tp, ids, forced)


def _traffic(vocab, n, seed):
    rng = np.random.default_rng(seed)
    return ([rng.integers(3, vocab, int(rng.integers(6, 16))).tolist() for _ in range(n)],
            [int(rng.integers(10, 21)) for _ in range(n)])


ENGINE = dict(num_slots=3, n_pages=9, page_size=8, max_pages_per_seq=8,
              prefill_buckets=(16,))         # 8 usable pages: this traffic preempts once


def _single(cfg, lcfg, params, lora, prompts, max_new, **kw):
    b = PagedBatcher(params, lora, cfg, lcfg, eos_id=-1, device="cpu", **{**ENGINE, **kw})
    reqs = [b.submit(p, n) for p, n in zip(prompts, max_new)]
    b.run_to_completion()
    return [r.generated for r in reqs], b.preemptions


def _near_best(cfg, lcfg, params, lora, prompts, got, admissions=None, tol=TIE):
    """Every token of got (an engine's) scores within tol of the best under
    the single device's teacher-forced logits over the context the engine
    decoded it from (the prompt, or at a re-admission after preemption the
    last L of prompt + generated: `admissions`, per request [(n, L)] from
    the engine's ``admission_log``), and a shifted token would not (the
    check can fail); returns the largest shortfall."""
    worst = 0.0
    for i, (p, g) in enumerate(zip(prompts, got)):
        adm = admissions[i] if admissions else [(0, len(p))]
        for k, (n, L) in enumerate(adm):
            end = adm[k + 1][0] if k + 1 < len(adm) else len(g)
            ctx = (list(p) + g[:n])[-L:]
            with torch.no_grad():
                logits = forward(params, lora, torch.tensor([ctx + g[n:end]]), cfg,
                                 lcfg)[0][0, len(ctx) - 1:-1]
            tok = torch.tensor(g[n:end])[:, None]
            best = logits.max(-1).values
            short = best - logits.gather(1, tok)[:, 0]
            shifted = best - logits.gather(1, (tok + 1) % cfg.vocab_size)[:, 0]
            assert (short <= tol).all(), (i, k, short, g)
            assert shifted.median() > tol
            worst = max(worst, short.max().item())
    return worst


def _agree(cfg, lcfg, params, lora, prompts, want, got):
    """got equals want (the single device's tokens) up to each request's
    first top-2 margin under TIE; returns the tokens compared."""
    compared = 0
    for p, w, g in zip(prompts, want, got):
        with torch.no_grad():
            logits = forward(params, lora, torch.tensor([p + w]), cfg, lcfg)[0][0, len(p) - 1:-1]
        top2 = logits.topk(2, dim=-1).values
        ties = ((top2[:, 0] - top2[:, 1]) < TIE).nonzero()
        upto = min(int(ties[0]) if len(ties) else len(w), len(g))
        assert g[:upto] == w[:upto], (upto, w, g)
        compared += upto
    return compared


@pytest.fixture(scope="module")
def worlds():
    """Run every case in a world of 2 ranks and one of 4; each rank's
    results, and what the parent holds them against."""
    torch.manual_seed(0)
    models = {k: _model(v) for k, v in FORWARDS.items()}
    ref, cases2, cases4 = {}, [], []
    for name in FORWARDS:
        case, ref[f"{name}-2"] = _case(f"{name}-2", models[name], 2)
        cases2.append(case)
    case, ref["cfg-4"] = _case("cfg-4", models["cfg"], 4)
    cases4.append(case)

    jcfg, cfg, jparams, jlora, jlcfg, lcfg = models["gqa"]
    ids, forced = _inputs(cfg.vocab_size, seed=3)
    cases2.append(("paged", "paged_forced_logits", dict(
        cfg=cfg, lcfg=lcfg, params_np=jax_to_numpy(jparams), lora_np=jax_to_numpy(jlora),
        ids=ids, forced=forced, page=8)))
    ref["paged"] = _jax_forced(jcfg, jparams, jlora, jlcfg, 2, ids, forced)

    jcfg, cfg, jparams, jlora, jlcfg, lcfg = models["cfg"]
    pnp, lnp = jax_to_numpy(jparams), jax_to_numpy(jlora)
    prompts, max_new = _traffic(cfg.vocab_size, 5, seed=4)
    engine = lambda **kw: dict(cfg=cfg, lcfg=lcfg, params_np=pnp, lora_np=lnp,
                               prompts=prompts, max_new=max_new, engine={**ENGINE, **kw})
    for cases in (cases2, cases4):
        cases.append(("batcher", "batcher", engine()))
    cases2 += [("int8", "batcher", engine(decode_impl="int8", prefill_impl="w8a8")),
               ("spec", "batcher", engine(spec_draft_len=3)),
               ("budget", "int8_budget", dict(cfg=cfg, lcfg=lcfg, params_np=pnp, ids=ids)),
               ("serve_tp", "serve_tp_tokens", dict(cfg=cfg, params_np=pnp, ids=prompts[0],
                                                    max_new=8))]
    rng = np.random.default_rng(6)
    x, w1, w2 = (rng.normal(size=s).astype(np.float32) for s in ((5, 8), (8, 6), (6, 8)))
    cases2.append(("grads", "conjugate_grads", dict(x=x, w1=w1, w2=w2)))
    cases2.append(("same", "same_counts", {}))
    ref["grads"] = (x, w1, w2)
    params, lora = bridge(jparams, jlora, cfg)
    ref["engine"] = (cfg, lcfg, params, lora, prompts, max_new)

    out = {}
    for tp, cases in ((2, cases2), (4, cases4)):
        with tempfile.TemporaryDirectory() as store:
            out[tp] = run_ranks(torch_tp_worker.world, tp, cases, backend="gloo",
                                devices=["cpu"] * tp, store_dir=store, timeout_s=600)
    return out, ref


@pytest.mark.parametrize("case", ["cfg-2", "cfg-4", "gqa-2", "neox-2"])
def test_tp_forward_matches_jax_single_device(worlds, case):
    """Prefill, then teacher-forced decode over the contiguous cache of each
    rank's heads; debug-neox checks the packed qkv's split by heads and the
    row-parallel bias."""
    out, ref = worlds
    ranks = out[int(case[-1])]
    got = ranks[0][case]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[case], got)        # every rank the same logits
    np.testing.assert_allclose(got, ref[case], rtol=0, atol=ATOL)
    assert (got.argmax(-1) == ref[case].argmax(-1)).mean() >= ARGMAX


def test_tp_paged_forward_matches_jax(worlds):
    """The decode steps over paged pools of each rank's KVH/tp heads."""
    out, ref = worlds
    got, heads = out[2][0]["paged"]
    assert heads == GQA["num_kv_heads"] // 2
    np.testing.assert_allclose(got, ref["paged"], rtol=0, atol=ATOL)
    assert (got.argmax(-1) == ref["paged"].argmax(-1)).mean() >= ARGMAX


@pytest.mark.parametrize("tp", [2, 4])
def test_paged_batcher_over_tp_mesh(worlds, tp):
    """Admission, paged decode and retirement through a pool that preempts:
    every rank's tokens equal, every page recycled, pools of KVH/tp heads,
    one step a dispatch, tokens equal to the single device's up to the
    first near-tie."""
    out, ref = worlds
    cfg, lcfg, params, lora, prompts, max_new = ref["engine"]
    runs = [r["batcher"] for r in out[tp]]
    assert all(r["tokens"] == runs[0]["tokens"] and r["disagreements"] == 0 for r in runs)
    run = runs[0]
    want, preemptions = _single(cfg, lcfg, params, lora, prompts, max_new)
    assert preemptions > 0 and run["preemptions"] == preemptions
    assert [len(t) for t in run["tokens"]] == max_new
    assert run["free"][0] == run["free"][1] == ENGINE["n_pages"] - 1
    assert run["pool_heads"] == cfg.num_kv_heads // tp and run["steps_per_dispatch"] == 1
    assert _agree(cfg, lcfg, params, lora, prompts, want, run["tokens"]) > 0
    assert any(len(a) > 1 for a in run["admissions"])       # a re-admission checked too
    _near_best(cfg, lcfg, params, lora, prompts, run["tokens"], run["admissions"])


def test_paged_batcher_tp_int8_decode(worlds):
    """The chunk-local int8 tree: wo a per-column int8 K-chunk of its rank
    (self-contained, ``k_shards`` 1), the lm_head dense; the loop runs to
    its budget; one decode step within JAX's budget of the exact tp path
    (0.1 of the largest |exact logit|)."""
    out, ref = worlds
    cfg = ref["engine"][0]
    for r in out[2]:
        run = r["int8"]
        assert run["wo8"] == ("int8", 1, (cfg.hidden_size // 2, cfg.hidden_size),
                              cfg.hidden_size // 2)
        assert run["disagreements"] == 0
        assert run["lm_head"] == "DenseLinear"
        assert [len(t) for t in run["tokens"]] == ref["engine"][5]
        assert run["free"][0] == run["free"][1]
        assert r["budget"] < 0.1
    assert out[2][1]["int8"]["tokens"] == out[2][0]["int8"]["tokens"]


def test_paged_batcher_tp_speculative(worlds):
    """One [slots, C] verify chunk a dispatch, acceptance on the host:
    tokens equal to the single device's up to the first near-tie, as the
    plain tp engine's."""
    out, ref = worlds
    cfg, lcfg, params, lora, prompts, max_new = ref["engine"]
    run = out[2][0]["spec"]
    assert out[2][1]["spec"]["tokens"] == run["tokens"]
    assert all(r["spec"]["disagreements"] == 0 for r in out[2])
    assert run["spec"][1] > 0 and run["free"][0] == run["free"][1]
    want, _ = _single(cfg, lcfg, params, lora, prompts, max_new)
    assert _agree(cfg, lcfg, params, lora, prompts, want, run["tokens"]) > 0
    _near_best(cfg, lcfg, params, lora, prompts, run["tokens"], run["admissions"])


def test_conjugate_operators_gradients(worlds):
    """ident-fwd/psum-bwd, gather-fwd/slice-bwd and psum-fwd/ident-bwd give
    each rank the gradients of the same computation on one rank: x's whole,
    its columns of w1's, its rows of w2's."""
    out, ref = worlds
    x, w1, w2 = (torch.from_numpy(a).requires_grad_(True) for a in ref["grads"])
    y = x @ w1
    o = torch.tanh(y) @ w2
    loss = (y ** 2).sum() * 0.5 + (o * torch.linspace(-1, 1, o.shape[1])).sum()
    loss.backward()
    n = w1.shape[1] // 2
    for r, rank in enumerate(out[2]):
        got_loss, gx, gw1, gw2 = rank["grads"]
        assert abs(got_loss - loss.item()) <= 1e-5 * abs(loss.item())
        np.testing.assert_allclose(gx, x.grad.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(gw1, w1.grad[:, r * n:(r + 1) * n].numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(gw2, w2.grad[r * n:(r + 1) * n].numpy(), rtol=1e-5, atol=1e-5)


def test_serve_tp_rank_matches_the_single_device(worlds):
    """examples/serve_tp's rank function: greedy tokens, the same on every
    rank, equal to the single device's greedy decode up to the first
    near-tie."""
    out, ref = worlds
    cfg, lcfg, params, _, prompts, _ = ref["engine"]
    got, _ = out[2][0]["serve_tp"]
    assert out[2][1]["serve_tp"][0] == got and len(got) == 8
    assert all(r["serve_tp"][1] == 0 for r in out[2])
    want, _ = _single(cfg, lcfg, params, None, prompts[:1], [8])
    _agree(cfg, lcfg, params, None, prompts[:1], want, [got])
    _near_best(cfg, lcfg, params, None, prompts[:1], [got])


def test_tp_mesh_same_counts_ranks_that_differ(worlds):
    """``TPMesh.same``: rank 0's tensor on every rank, a call in which some
    rank's differed counted once, a call in which none did not at all."""
    out, _ = worlds
    for r in out[2]:
        assert r["same"] == ([0, 7], 1, [3, 7], 1)


def test_serve_tp_main_debug(capsys, monkeypatch):
    """``serve_tp --debug --device cpu``: two ranks of its own on the JAX
    example's debug model, the prompt and its greedy text printed; on the
    card it asks for a card a rank."""
    from qlora_tpu_torch.examples import serve_tp

    out = serve_tp.main(["--debug", "--device", "cpu", "--max_new_tokens", "6",
                         "--prompt", "Hello"])
    printed = capsys.readouterr().out
    assert "tp=2 over gloo (cpu, cpu)" in printed and len(out) == 6
    assert all(0 <= t < serve_tp.DEBUG_CONFIG["vocab_size"] for t in out)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 cards, have 1"):
        serve_tp.main(["--debug", "--tp", "2"])
