"""Port speculative acceptance (``generate/speculative.py``) against the JAX
package's.

``_target_probs`` is the same f32 arithmetic on the same numpy logits:
within 1e-6.  ``accept_and_resample`` draws from a ``torch.Generator``,
whose numbers differ from ``jax.random``'s, so its structure is checked:
point-mass targets give the greedy-exact answer, a token after a rejection
comes only from the residual, and the first emitted token is distributed
as the target (the JAX test's budget, total variation < 0.02 over 40k
draws)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qlora_tpu.generate.sampler import SamplingParams as JSamplingParams
from qlora_tpu.generate.speculative import _target_probs as jtarget_probs

from qlora_tpu_torch.generate.sampler import SamplingParams
from qlora_tpu_torch.generate.speculative import _target_probs, accept_and_resample

torch.set_num_threads(2)


@pytest.mark.parametrize("kw", [
    dict(), dict(temperature=0.7), dict(top_k=5), dict(top_p=0.8),
    dict(typical_p=0.9, temperature=1.3),
])
def test_target_probs_match_jax(kw):
    x = np.random.default_rng(len(kw)).normal(size=(6, 64)).astype(np.float32) * 3
    want = np.asarray(jtarget_probs(jnp.asarray(x), JSamplingParams(do_sample=True, **kw)))
    got = _target_probs(torch.from_numpy(x), SamplingParams(do_sample=True, **kw)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert ((got > 0) == (want > 0)).all()


def test_point_mass_targets_are_greedy_exact():
    """With one-hot targets, drafts equal to the target are always accepted
    and the first wrong draft is replaced by the target's token."""
    V, k = 16, 4
    target = torch.tensor([[3, 5, 7, 9, 11], [3, 5, 2, 9, 11], [1, 1, 1, 1, 1]])
    probs = torch.nn.functional.one_hot(target, V).float()
    drafts = torch.tensor([[3, 5, 7, 9], [3, 5, 7, 9], [0, 1, 1, 1]])
    g = torch.Generator().manual_seed(0)
    toks, n_acc = accept_and_resample(probs, drafts, g)
    assert toks.dtype == torch.int32 and toks.shape == (3, k + 1)
    assert n_acc.tolist() == [5, 3, 1]
    for b, n in enumerate(n_acc.tolist()):
        assert toks[b, :n].tolist() == target[b, :n].tolist()


def test_resample_after_rejection_avoids_the_draft():
    """A rejected draft has its mass removed: the replacement is never the
    rejected token and only ever a token the target allows."""
    V, n = 8, 4000
    p = torch.tensor([0.0, 0.5, 0.0, 0.3, 0.2, 0.0, 0.0, 0.0])
    probs = p.expand(n, 2, V).contiguous()
    drafts = torch.full((n, 1), 1)
    toks, n_acc = accept_and_resample(probs, drafts, torch.Generator().manual_seed(1))
    rejected = n_acc == 1
    assert 0.4 < rejected.float().mean().item() < 0.6       # 1 - p(d)
    repl = toks[rejected, 0]
    assert set(repl.unique().tolist()) <= {3, 4}
    assert (toks[~rejected, 0] == 1).all()


def test_first_token_is_distributed_as_the_target():
    V, n = 8, 40000
    p = torch.tensor([0.30, 0.02, 0.18, 0.05, 0.20, 0.10, 0.05, 0.10])
    probs = p.expand(n, 2, V).contiguous()
    for d in (0, 1, 4):
        toks, n_acc = accept_and_resample(probs, torch.full((n, 1), d),
                                          torch.Generator().manual_seed(d))
        emp = torch.bincount(toks[:, 0].long(), minlength=V).float() / n
        assert 0.5 * (emp - p).abs().sum().item() < 0.02
        assert abs((n_acc == 2).float().mean().item() - p[d].item()) < 0.02
