"""Port ``ContinuousBatcher`` (slot-based continuous batching over the
contiguous cache), as tests/test_continuous.py pins the JAX engine, plus
one check of the slice against the JAX ``ContinuousBatcher`` on the same
weights: the first tokens (from the prefill) equal, and every later token
equal as long as JAX's own top-2 margin at that step is clear."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qlora_tpu.generate.continuous import ContinuousBatcher as JContinuousBatcher
from qlora_tpu.models import forward as jforward
from qlora_tpu.models import get_config as jget_config
from qlora_tpu.models import init_params as jinit_params

from qlora_tpu_torch.generate import generate
from qlora_tpu_torch.generate.continuous import ContinuousBatcher
from qlora_tpu_torch.models import get_config, init_params
from test_torch_convert import bridge

torch.set_num_threads(2)
MARGIN = 0.2   # twice the logits' atol against JAX (see test_torch_generate)


@pytest.fixture(scope="module")
def debug_params():
    cfg = get_config("debug")
    return cfg, init_params(cfg, seed=0, device="cpu")


def _batcher(params, cfg, **kw):
    return ContinuousBatcher(params, None, cfg, **{**dict(
        num_slots=2, max_len=64, prefill_buckets=(16,), eos_id=-1, device="cpu"), **kw})


def _reference(params, cfg, prompt, n):
    return generate(params, None, torch.tensor([prompt]), torch.tensor([len(prompt)]), cfg,
                    max_new_tokens=n, eos_id=-1, device="cpu")[0].tolist()


def test_single_and_concurrent_requests_match_generate(debug_params):
    cfg, params = debug_params
    p1, p2 = [3, 17, 5, 9], [4, 7]
    cb = _batcher(params, cfg)
    r1, r2 = cb.submit(p1, max_new_tokens=5), cb.submit(p2, max_new_tokens=4)
    cb.run_to_completion()
    assert r1.generated == _reference(params, cfg, p1, 5)
    assert r2.generated == _reference(params, cfg, p2, 4)


def test_slot_reuse_after_finish(debug_params):
    cfg, params = debug_params
    cb = _batcher(params, cfg, num_slots=1)
    reqs = [cb.submit([3, 5 + i], max_new_tokens=3) for i in range(3)]
    done = cb.run_to_completion()
    assert len(done) >= 2 and all(r.done for r in reqs)
    for i, r in enumerate(reqs):
        assert r.generated == _reference(params, cfg, [3, 5 + i], 3), f"req {i}"


def test_streaming_callback_and_eos(debug_params):
    cfg, params = debug_params
    seen = []
    cb = _batcher(params, cfg)
    r = cb.submit([3, 9], max_new_tokens=4, on_token=lambda uid, t: seen.append((uid, t)))
    cb.run_to_completion()
    assert [t for _, t in seen] == r.generated and len(seen) == 4
    # eos = the first token: the request ends at once with nothing emitted
    cb = _batcher(params, cfg, eos_id=r.generated[0])
    r2 = cb.submit([3, 9], max_new_tokens=4)
    cb.run_to_completion()
    assert r2.done and r2.generated == []


def test_free_slots_stay_at_length_zero(debug_params):
    """A slot without a request does not advance while the others decode."""
    cfg, params = debug_params
    cb = _batcher(params, cfg, num_slots=3)
    r = cb.submit([3, 9, 4], max_new_tokens=5)
    for _ in range(3):
        cb.step()
    assert cb.cache["length"].tolist() == [3 + 3, 0, 0] and len(r.generated) == 4


def test_engine_needs_a_device_or_cuda(debug_params):
    cfg, params = debug_params
    with pytest.raises(ValueError, match="params live on"):
        _batcher(params, cfg, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _batcher(params, cfg, device=None)


def test_matches_jax_continuous_batcher():
    jcfg, cfg = jget_config("debug"), get_config("debug")
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
    params, _ = bridge(jparams, None, cfg)
    prompts = [[3, 17, 5, 9], [4, 7], [11, 2, 6, 8, 1]]
    kw = dict(num_slots=2, max_len=32, prefill_buckets=(16,), eos_id=-1)
    jcb = JContinuousBatcher(jparams, None, jcfg, **kw)
    jreqs = [jcb.submit(p, max_new_tokens=6) for p in prompts]
    jcb.run_to_completion()
    cb = ContinuousBatcher(params, None, cfg, device="cpu", **kw)
    reqs = [cb.submit(p, max_new_tokens=6) for p in prompts]
    cb.run_to_completion()
    for prompt, jr, r in zip(prompts, jreqs, reqs):
        assert len(r.generated) == len(jr.generated) == 6
        assert r.generated[0] == jr.generated[0]
        # each later token equal while JAX's decision at that step is clear
        ctx = list(prompt)
        for t, (mine, want) in enumerate(zip(r.generated, jr.generated)):
            logits = np.asarray(jforward(jparams, None, jnp.asarray([ctx], jnp.int32), jcfg)[0],
                                np.float32)[0, -1]
            top2 = np.sort(logits)[-2:]
            if top2[1] - top2[0] <= MARGIN:
                break
            assert mine == want, (prompt, t)
            ctx.append(want)
