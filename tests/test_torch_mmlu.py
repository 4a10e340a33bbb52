"""The port's MMLU evaluator (``qlora_tpu_torch.eval.mmlu``) against the JAX
package's on the same inputs: the file loader, the answer-letter ids, and
``evaluate_mmlu`` over the bundled five-shot val and test slices on the
``debug`` weights carried across from JAX.

The port gathers the option logits and the masked loss on the device; the
JAX evaluator brings every logit to the host.  The option logits of each row
agree within ``LOGIT_ATOL`` (the logits' tolerance against JAX,
test_torch_model), the predicted letters wherever the top two options lie
more than twice that apart, the accuracies with JAX's pinned values
(tests/test_mmlu.py) and ``mmlu_loss`` within ``LOSS_RTOL``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qlora_tpu.cli import Args as JArgs
from qlora_tpu.cli import _resolve_mmlu_path as jresolve
from qlora_tpu.eval import abcd_token_ids as jabcd
from qlora_tpu.eval import evaluate_mmlu as jevaluate
from qlora_tpu.eval import load_mmlu_file as jload
from qlora_tpu.lora import LoraConfig as JLoraConfig
from qlora_tpu.models import get_config as jget_config
from qlora_tpu.models import init_params as jinit_params
from qlora_tpu.models.transformer import forward as jforward
from qlora_tpu.train.collator import CausalCollator as JCollator
from qlora_tpu.utils.testing import FakeTokenizer as JFakeTokenizer

from qlora_tpu_torch.eval import abcd_token_ids, evaluate_mmlu, load_mmlu_file, mmlu_batch
from qlora_tpu_torch.lora import LoraConfig
from qlora_tpu_torch.models import get_config
from qlora_tpu_torch.train import CausalCollator
from qlora_tpu_torch.utils import FakeTokenizer
from test_torch_convert import bridge

torch.set_num_threads(2)
LOGIT_ATOL = 0.1
LOSS_RTOL = 1e-3
PINNED = {"val": 8 / 24, "test": 0.2288888888888889}     # tests/test_mmlu.py


@pytest.mark.parametrize("layout", ["list", "columnar", "jsonl"])
def test_load_mmlu_file_matches_jax(tmp_path, layout):
    rows = [{"subject": s, "input": f"Q{i}? Answer:", "output": "ABCD"[i % 4]}
            for i, s in enumerate(["math", "cs", "law", "math", "bio"])]
    p = tmp_path / f"{layout}.json"
    if layout == "list":
        p.write_text(json.dumps(rows))
    elif layout == "columnar":
        p.write_text(json.dumps({k: [r[k] for r in rows] for k in rows[0]}))
    else:
        p.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    for n in (None, 3):
        got = load_mmlu_file(str(p), max_samples=n)
        assert got == jload(str(p), max_samples=n) == rows[:n]


def test_abcd_token_ids_match_jax():
    assert abcd_token_ids(FakeTokenizer()) == jabcd(JFakeTokenizer())
    assert len(set(abcd_token_ids(FakeTokenizer()))) == 4


@pytest.fixture(scope="module")
def debug_model():
    jcfg, cfg = jget_config("debug"), get_config("debug")
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg, quantized=True)
    params, _ = bridge(jparams, None, cfg)
    return jcfg, jparams, cfg, params


@pytest.mark.parametrize("split", ["val", "test"])
def test_evaluate_mmlu_matches_jax(debug_model, split):
    jcfg, jparams, cfg, params = debug_model
    path = jresolve(JArgs(mmlu_dataset="mmlu-fs", mmlu_split="eval" if split == "val"
                          else "test"))
    rows = load_mmlu_file(path, max_samples=24)
    tok, jtok = FakeTokenizer(), JFakeTokenizer()
    kw = dict(batch_size=4, source_max_len=512)
    got = evaluate_mmlu(params, None, cfg, tok, rows, lcfg=LoraConfig(r=4), device="cpu", **kw)
    want = jevaluate(jparams, None, jcfg, jtok, rows, lcfg=JLoraConfig(r=4), **kw)
    assert abs(got["mmlu_eval_accuracy"] - PINNED[split]) < 1e-6
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k.startswith("mmlu_eval_accuracy"):
            assert got[k] == pytest.approx(v, abs=1e-9), k
    assert got["mmlu_loss"] == pytest.approx(want["mmlu_loss"], rel=LOSS_RTOL)

    # row by row: the option logits the port gathers on the device against
    # JAX's full logits at the same positions
    coll = CausalCollator(tok, source_max_len=512, target_max_len=16, pad_to=528)
    jcoll = JCollator(jtok, source_max_len=512, target_max_len=16, pad_to=528)
    abcd = torch.tensor(abcd_token_ids(tok))
    jlogits = jax.jit(lambda ids, mask: jforward(jparams, None, ids, jcfg, JLoraConfig(r=4),
                                                 attn_mask=mask)[0])
    compared = 0
    for i in range(0, len(rows), 4):
        chunk = rows[i:i + 4]
        batch, jbatch = coll(chunk), jcoll(chunk)
        for k in batch:
            np.testing.assert_array_equal(batch[k], jbatch[k])
        _, _, options, has = mmlu_batch(params, None, cfg, LoraConfig(r=4), batch, abcd)
        logits = np.asarray(jlogits(jnp.asarray(jbatch["input_ids"]),
                                    jnp.asarray(jbatch["attention_mask"])), np.float32)
        for b in range(len(chunk)):
            assert bool(has[b])
            p = int(np.nonzero(jbatch["labels"][b] != -100)[0][0])
            want_opt = logits[b, p - 1][np.asarray(jabcd(jtok))]
            np.testing.assert_allclose(options[b].numpy(), want_opt, atol=LOGIT_ATOL)
            top2 = np.sort(want_opt)[-2:]
            if top2[1] - top2[0] > 2 * LOGIT_ATOL:
                assert int(options[b].argmax()) == int(want_opt.argmax())
                compared += 1
    assert compared > 0


def test_evaluate_mmlu_needs_a_device_or_cuda(debug_model):
    _, _, cfg, params = debug_model
    rows = [{"subject": "s", "input": "Which? Answer:", "output": "A"}]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            evaluate_mmlu(params, None, cfg, FakeTokenizer(), rows)
    with pytest.raises(ValueError, match="params live on"):
        evaluate_mmlu(params, None, cfg, FakeTokenizer(), rows, device="meta")
