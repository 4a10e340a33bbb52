"""The port's driver (``qlora_tpu_torch.cli``) against the JAX package's.

The JAX driver's end-to-end tests are ``slow`` (tests/test_e2e.py), so the
port is held against JAX's functions, not a JAX CLI run: the flag surface,
the data plan (``_iter_batches``), the eval and predict batching, the
checkpoint pruning and the MMLU file resolution equal JAX's; a training run
on ``debug-neox`` (the shape of test_e2e's) falls, writes what JAX's writes
and resumes bit for bit; an eval and predict run over a store that JAX
wrote gives JAX's ``make_eval_step`` loss within ``LOSS_RTOL`` and JAX's
greedy ``generate`` tokens up to the first near-tie (``MARGIN``, twice the
logits' atol against JAX, test_torch_model)."""

import dataclasses
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qlora_tpu.cli as jcli
from qlora_tpu.generate import SamplingParams as JSamplingParams
from qlora_tpu.generate import generate as jgenerate
from qlora_tpu.lora import LoraConfig as JLoraConfig
from qlora_tpu.models import get_config as jget_config
from qlora_tpu.models import init_params as jinit_params
from qlora_tpu.models.transformer import init_lora_params as jinit_lora
from qlora_tpu.train import make_eval_step as jmake_eval_step
from qlora_tpu.train.collator import CausalCollator as JCollator
from qlora_tpu.train.data import make_dataset as jmake_dataset
from qlora_tpu.utils.quantized_store import save_quantized as jsave_quantized
from qlora_tpu.utils.testing import FakeTokenizer as JFakeTokenizer

import qlora_tpu_torch.cli as cli
import qlora_tpu_torch.generate as tgenerate
from qlora_tpu_torch.models import forward, get_config
from qlora_tpu_torch.train import CausalCollator
from qlora_tpu_torch.utils import FakeTokenizer, load_quantized
from qlora_tpu_torch.utils.checkpoint import read_arrays

torch.set_num_threads(2)
LOSS_RTOL = 1e-3
MARGIN = 0.2


def test_args_match_jax_plus_device():
    jf = {f.name: (f.type, f.default) for f in dataclasses.fields(jcli.Args)}
    tf = {f.name: (f.type, f.default) for f in dataclasses.fields(cli.Args)}
    assert tf.pop("device") == ("Optional[str]", None)
    assert list(tf) == list(jf) and tf == jf
    argv = ["--model_name_or_path", "debug", "--bits", "8", "--lora_dropout", "0.1",
            "--group_by_length", "false", "--do_eval", "--max_eval_samples", "4",
            "--penalty_alpha", "0.6", "--learning_rate", "1e-3"]
    got = dataclasses.asdict(cli.parse_args(argv + ["--device", "cpu"]))
    assert got.pop("device") == "cpu"
    assert got == dataclasses.asdict(jcli.parse_args(argv))


def test_unknown_flags_error():
    with pytest.raises(SystemExit):
        cli.parse_args(["--definitely_not_a_flag", "1"])
    with pytest.raises(SystemExit):
        cli.parse_args(["--lora_"])          # no abbreviations


def _examples(n, seed=3):
    rng = np.random.default_rng(seed)
    return [{"input": "q" * int(rng.integers(2, 110)), "output": "a" * int(rng.integers(1, 30))}
            for _ in range(n)]


# (examples, batch, accum, group_by_length, skip_steps, batches taken)
PLANS = {
    "shuffled": (12, 2, 1, False, 0, 8),
    "shuffled-skip": (12, 2, 1, False, 3, 5),
    "grouped-accum": (20, 3, 2, True, 0, 6),
    "grouped-skip": (20, 3, 2, True, 2, 4),
    "accum-across-epochs": (8, 2, 16, True, 0, 2),       # 4 full batches an epoch
    "accum-across-epochs-skip": (8, 2, 16, True, 1, 1),  # C10: a group straddles the resume
    "ragged-tail-accum": (11, 4, 3, False, 4, 3),
    "no-full-batch": (3, 8, 1, False, 0, 1),
}
C10 = {"accum-across-epochs-skip"}


@pytest.mark.parametrize("case", list(PLANS))
def test_iter_batches_match_jax(case):
    """The port's stream, resumed after `skip` steps, equals JAX's
    uninterrupted stream from that step on, array for array.  JAX's own
    resume equals it too, except where a group of another bucket is part
    filled when the skipping ends: there JAX stacks its placeholder and
    fails (ROADMAP C10), and the port completes the group."""
    n, bs, accum, group, skip, take = PLANS[case]
    exs = _examples(n)

    def stream(mod, collator, tokenizer, skip_steps):
        return mod._iter_batches(exs, collator(tokenizer(), 96, 32), bs, accum, seed=7,
                                 group_by_length=group, tokenizer=tokenizer(), max_len=128,
                                 skip_steps=skip_steps)

    ours = stream(cli, CausalCollator, FakeTokenizer, skip)
    theirs = stream(jcli, JCollator, JFakeTokenizer, 0)
    if case == "no-full-batch":
        for it in (ours, theirs):
            with pytest.raises(ValueError, match="no full batch"):
                next(it)
        return
    for _ in range(skip):
        next(theirs)
    got = [next(ours) for _ in range(take)]
    for a, b in zip(got, (next(theirs) for _ in range(take))):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        assert a["input_ids"].shape[:-1] == ((accum, bs) if accum > 1 else (bs,))
    jax_resumed = stream(jcli, JCollator, JFakeTokenizer, skip)
    if case in C10:
        with pytest.raises(TypeError):
            [next(jax_resumed) for _ in range(take)]
    else:
        for a, b in zip(got, (next(jax_resumed) for _ in range(take))):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_padded_batches_and_mask_pad_rows_match_jax():
    ds = [{"i": i} for i in range(10)]
    for bs in (1, 3, 4, 10, 12):
        assert list(cli._padded_batches(ds, bs)) == list(jcli._padded_batches(ds, bs))
    batch = {"input_ids": np.ones((4, 8), np.int32), "labels": np.ones((4, 8), np.int32)}
    for n_real in (4, 2, 0):
        a, b = cli._mask_pad_rows(batch, n_real), jcli._mask_pad_rows(batch, n_real)
        np.testing.assert_array_equal(a["labels"], b["labels"])
    assert (batch["labels"] == 1).all()


@pytest.mark.parametrize("keep", [0, 1, 2, 5])
def test_prune_checkpoints_matches_jax(tmp_path, keep):
    kept = []
    for mod in (cli, jcli):
        out = tmp_path / mod.__name__
        for step in (3, 10, 7, 1):
            (out / f"checkpoint-{step}").mkdir(parents=True)
        (out / "checkpoint-x").mkdir()
        (out / "metrics.json").write_text("{}")
        mod._prune_checkpoints(str(out), keep)
        kept.append(sorted(os.listdir(out)))
    assert kept[0] == kept[1]


@pytest.mark.parametrize("dataset,split", [("mmlu-zs", "eval"), ("mmlu-zs", "test"),
                                           ("mmlu-fs", "eval"), ("mmlu-fs", "test")])
def test_resolve_mmlu_path_matches_jax(caplog, dataset, split):
    seen = []
    for mod in (cli, jcli):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            path = mod._resolve_mmlu_path(mod.Args(mmlu_dataset=dataset, mmlu_split=split))
        seen.append((path, any("NOT comparable" in r.message for r in caplog.records)))
    assert seen[0] == seen[1]
    path, warned = seen[0]
    assert os.path.exists(path)
    # the canonical zero-shot val file alone is no derived split
    assert warned == (not path.endswith("zero_shot_mmlu_val.json"))
    assert cli._resolve_mmlu_path(cli.Args(mmlu_data_path="x.json")) == "x.json"


def _write_alpaca(path, n=64):
    rows = [{"input": f"Repeat the word apple {i} times.", "output": "apple " * 3}
            for i in range(n)]
    path.write_text(json.dumps(rows))
    return str(path)


def _base(data, out, **kw):
    return dict(model_name_or_path="debug-neox", init_random=True, fake_tokenizer=True,
                dataset=data, output_dir=out, device="cpu", **kw)


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """tests/test_e2e.py's run on the port, with in-training eval and MMLU."""
    tmp = tmp_path_factory.mktemp("e2e")
    data = _write_alpaca(tmp / "data.json")
    mmlu = tmp / "mmlu.json"
    mmlu.write_text(json.dumps([{"subject": "s", "input": "Which? Answer:", "output": "A"},
                                {"subject": "s", "input": "Pick. Answer:", "output": "B"}]))
    out = str(tmp / "out")
    args = cli.Args(**_base(
        data, out, max_steps=10, per_device_train_batch_size=4, gradient_accumulation_steps=1,
        learning_rate=5e-3, lora_r=8, source_max_len=48, target_max_len=24, logging_steps=1,
        save_steps=5, group_by_length=True, do_train=True, do_eval=True, do_predict=True,
        eval_dataset_size=8, max_eval_samples=4, per_device_eval_batch_size=2,
        max_new_tokens=8, seed=0, eval_steps=5, do_mmlu_eval=True, mmlu_data_path=str(mmlu),
        mmlu_source_max_len=64))
    return tmp, out, args, cli.train(args)


def test_train_run_falls_and_writes_what_jax_writes(e2e):
    _, out, _, metrics = e2e
    hist = metrics["train_metrics"]
    assert [h["step"] for h in hist] == list(range(1, 11))
    assert hist[-1]["loss"] < hist[0]["loss"], hist
    for step in (5, 10):
        assert os.path.isdir(os.path.join(out, f"checkpoint-{step}", "adapter_model"))
    assert os.path.exists(os.path.join(out, "checkpoint-10", "optimizer_state.npz"))
    assert os.path.exists(os.path.join(out, "completed"))
    assert np.isfinite(metrics["eval_loss"])
    preds = [json.loads(line) for line in open(os.path.join(out, "predictions.jsonl"))]
    assert len(preds) == 4 and all("prediction" in p for p in preds)
    # the keys qlora_tpu/cli.py: train writes for these flags
    assert set(json.load(open(os.path.join(out, "metrics.json")))) == {
        "run_name", "train_metrics", "eval_loss", "predictions_path",
        "seconds_per_step_mean", "mmlu_loss", "mmlu_eval_accuracy", "mmlu_eval_accuracy_s"}
    log = [json.loads(line) for line in open(os.path.join(out, "train_log.jsonl"))]
    assert sum("eval_loss" in r for r in log) == 2          # steps 5 and 10
    assert sum("mmlu_eval_accuracy" in r for r in log) == 2
    # the checkpoint is JAX's layout: stacked layers under JAX's names
    arrays = read_arrays(os.path.join(out, "checkpoint-10", "adapter_model",
                                      "adapter_weights.npz"))
    assert arrays["w_qkv/a"].shape == (2, 256, 8)


def test_completed_run_skips(e2e):
    _, out, args, _ = e2e
    m = cli.main(["--model_name_or_path", "debug-neox", "--output_dir", out,
                  "--dataset", "unused", "--device", "cpu"])
    assert m == {"run_name": out}


def test_resume_is_bit_equal_to_the_uninterrupted_run(e2e):
    tmp = e2e[0]
    data = _write_alpaca(tmp / "resume.json", n=24)
    kw = dict(per_device_train_batch_size=2, gradient_accumulation_steps=2, lora_r=4,
              source_max_len=32, target_max_len=16, logging_steps=1, save_steps=3,
              group_by_length=True, learning_rate=5e-3)
    whole = cli.train(cli.Args(**_base(data, str(tmp / "whole"), max_steps=6, **kw)))
    cut = str(tmp / "cut")
    first = cli.train(cli.Args(**_base(data, cut, max_steps=3, **kw)))
    os.remove(os.path.join(cut, "completed"))     # an interrupted longer run
    rest = cli.train(cli.Args(**_base(data, cut, max_steps=6, **kw)))
    assert [h["step"] for h in rest["train_metrics"]] == [4, 5, 6]
    pick = lambda hist: [(h["loss"], h["grad_norm"]) for h in hist]
    assert pick(first["train_metrics"] + rest["train_metrics"]) == pick(whole["train_metrics"])
    a = read_arrays(os.path.join(tmp / "whole", "checkpoint-6", "adapter_model",
                                 "adapter_weights.npz"))
    b = read_arrays(os.path.join(cut, "checkpoint-6", "adapter_model", "adapter_weights.npz"))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_eval_and_predict_over_a_jax_store_match_jax(tmp_path, monkeypatch):
    jcfg, cfg = jget_config("debug"), get_config("debug")
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg, quantized=True)
    store = str(tmp_path / "store")
    jsave_quantized(store, jparams, jcfg)
    data = _write_alpaca(tmp_path / "data.json", n=16)
    rows = json.loads(open(data).read())
    for i, r in enumerate(rows):           # prompts of unequal lengths
        r["input"] += " and pears" * (i % 3)
    (tmp_path / "data.json").write_text(json.dumps(rows))
    made = []
    real_generate = tgenerate.generate

    def recording_generate(*a, **kw):
        toks = real_generate(*a, **kw)
        made.append(toks.clone())
        return toks

    monkeypatch.setattr(tgenerate, "generate", recording_generate)
    out = str(tmp_path / "out")
    m = cli.train(cli.Args(
        model_name_or_path=store, fake_tokenizer=True, dataset=data, output_dir=out,
        device="cpu", do_train=False, do_eval=True, do_predict=True, lora_r=4,
        eval_dataset_size=5, max_eval_samples=5, per_device_eval_batch_size=2,
        source_max_len=48, target_max_len=24, max_new_tokens=8))

    # JAX's eval step over the same batches (the port's fresh LoRA has B = 0)
    jtok = JFakeTokenizer()
    jcoll = JCollator(jtok, source_max_len=48, target_max_len=24, pad_to=72)
    jlcfg = JLoraConfig(r=4)
    jlora = jinit_lora(jax.random.PRNGKey(1), jcfg, jlcfg)
    _, eval_ds = jmake_dataset(data, do_eval=True, eval_dataset_size=5, max_eval_samples=5,
                               seed=42)
    ev = jmake_eval_step(jcfg, jlcfg)
    tot, n_tot = 0.0, 0
    for chunk, n_real in jcli._padded_batches(eval_ds, 2):
        b = jcli._mask_pad_rows(jcoll(chunk), n_real)
        loss, n = ev(jlora, jparams, {k: jnp.asarray(v) for k, v in b.items()})
        tot, n_tot = tot + float(loss) * int(n), n_tot + int(n)
    assert m["eval_loss"] == pytest.approx(tot / n_tot, rel=LOSS_RTOL)

    # predictions: JAX's greedy tokens up to the first near-tie of the port's forward
    params, _ = load_quantized(store, device="cpu")
    jcoll = JCollator(jtok, source_max_len=48, target_max_len=24, pad_to=48,
                      predict_with_generate=True)
    preds = [json.loads(line) for line in open(os.path.join(out, "predictions.jsonl"))]
    assert len(preds) == 5 and len(made) == 3
    tok = FakeTokenizer()
    clear = 0
    for (chunk, n_real), toks in zip(jcli._padded_batches(eval_ds, 2), made):
        b = jcoll(chunk)
        want = np.asarray(jgenerate(jparams, None, jnp.asarray(b["input_ids"]),
                                    jnp.asarray(b["attention_mask"].sum(-1)), jcfg, jlcfg,
                                    max_new_tokens=8, eos_id=2, sparams=JSamplingParams(),
                                    rng=jax.random.PRNGKey(0)))
        for row in range(n_real):
            L = int(b["attention_mask"][row].sum())
            prompt = b["input_ids"][row, :L].tolist()
            ids = torch.tensor([prompt + want[row].tolist()])
            with torch.inference_mode():
                logits = forward(params, None, ids, cfg)[0][0, L - 1:-1]
            top2 = logits.topk(2, dim=-1).values
            ties = ((top2[:, 0] - top2[:, 1]) <= MARGIN).nonzero()
            upto = int(ties[0]) if len(ties) else 8
            got = toks[row].tolist()
            assert got[:upto] == want[row].tolist()[:upto], (row, upto)
            clear += upto
    assert clear > 0
    rows_written = [t for toks in made for t in toks.tolist()][:5]
    for p, t in zip(preds, rows_written):
        assert p["prediction"] == tok.decode([i for i in t if i != 2])


# flags that select another of the port's paths: (Args fields, a file the run must write)
OPTIONS = {
    "bits8": (dict(bits=8), None),
    "full_finetune": (dict(full_finetune=True, bits=16, learning_rate=1e-4), None),
    "adam8bit": (dict(adam8bit=True), None),
    "optim_host_offload": (dict(optim_host_offload=True), None),
    "remat_full": (dict(remat_policy="full"), None),
    "predict_int8": (dict(do_predict=True, predict_decode_impl="int8"), "predictions.jsonl"),
    "report_profile": (dict(max_steps=6, report_profile=True), "profile/trace.json"),
}


@pytest.mark.parametrize("case", list(OPTIONS))
def test_option_paths_train_and_resume(tmp_path, case):
    """Each option's run takes its steps with finite losses, writes its
    checkpoint, and (with a step added) resumes from it."""
    extra, written = OPTIONS[case]
    data = _write_alpaca(tmp_path / "data.json", n=16)
    out = str(tmp_path / "out")
    kw = dict(per_device_train_batch_size=2, gradient_accumulation_steps=2, lora_r=4,
              source_max_len=32, target_max_len=16, logging_steps=1, save_steps=100,
              group_by_length=False, eval_dataset_size=4, max_eval_samples=2,
              per_device_eval_batch_size=2, max_new_tokens=4)
    kw.update(extra)
    steps = kw.pop("max_steps", 2)
    base = dict(_base(data, out, **kw), model_name_or_path="debug")
    m = cli.train(cli.Args(**{**base, "max_steps": steps}))
    losses = [h["loss"] for h in m["train_metrics"]]
    assert len(losses) == steps and np.isfinite(losses).all()
    if written:
        assert os.path.exists(os.path.join(out, written))
    os.remove(os.path.join(out, "completed"))
    m = cli.train(cli.Args(**{**base, "max_steps": steps + 1}))
    assert [h["step"] for h in m["train_metrics"]] == [steps + 1]


# the mesh combinations the JAX CLI refuses raise its exceptions (full
# finetuning shards by GSPMD alone, and not with sp); the port adds one: an
# 8-bit optimizer's blockwise state cannot follow the full model's shards
UNPORTED = {
    "full_finetune_megatron": (["--full_finetune", "--bits", "16", "--tp_style", "megatron",
                                "--mesh_tp", "2"], NotImplementedError, "shards via GSPMD"),
    "full_finetune_mesh_adam8bit": (["--full_finetune", "--bits", "16", "--mesh_fsdp", "2",
                                     "--adam8bit"], ValueError, "AdamW-family"),
"megatron_fsdp": (["--tp_style", "megatron", "--mesh_fsdp", "2"], ValueError,
                      "requires mesh_fsdp=1"),
    "megatron_adam8bit": (["--tp_style", "megatron", "--mesh_tp", "2", "--adam8bit"],
                          ValueError, "adam8bit does not compose"),
    "sp_megatron": (["--mesh_sp", "2", "--tp_style", "megatron", "--mesh_tp", "2"], ValueError,
                    "mesh_sp needs tp_style=gather"),
    "sp_full_finetune": (["--mesh_sp", "2", "--full_finetune", "--bits", "16"],
                         NotImplementedError, "does not compose with mesh_sp"),
}


@pytest.mark.parametrize("flag", list(UNPORTED))
def test_unported_flags_raise_naming_their_item(tmp_path, flag):
    argv, exc, match = UNPORTED[flag]
    with pytest.raises(exc, match=match):
        cli.main(["--output_dir", str(tmp_path), "--device", "cpu", *argv])
    assert not os.listdir(tmp_path)          # nothing built, nothing written


@pytest.fixture(scope="module")
def jax_store(tmp_path_factory):
    """The debug model saved by JAX, and an alpaca file of prompts of
    unequal lengths: both CLIs predict from the same weights."""
    tmp = tmp_path_factory.mktemp("search")
    jcfg = jget_config("debug")
    store = str(tmp / "store")
    jsave_quantized(store, jinit_params(jax.random.PRNGKey(0), jcfg, quantized=True), jcfg)
    data = _write_alpaca(tmp / "data.json", n=16)
    rows = json.loads(open(data).read())
    for i, r in enumerate(rows):
        r["input"] += " and pears" * (i % 3)
    (tmp / "data.json").write_text(json.dumps(rows))
    return tmp, store, data


# the predict flags that select a search or speculation (ported with ROADMAP A4, A5)
SEARCH_FLAGS = {
    "num_beams": dict(num_beams=4),
    "length_penalty": dict(num_beams=4, length_penalty=0.8),
    "num_beam_groups": dict(num_beams=4, num_beam_groups=2),
    "diversity_penalty": dict(num_beams=4, num_beam_groups=2, diversity_penalty=0.5),
    "penalty_alpha": dict(penalty_alpha=0.6, top_k=4),
    "predict_speculative": dict(predict_speculative=3),
}


LOGIT_TIE = 0.035    # the largest |logit| difference between the packages on the debug
                     # models, rounded up (test_torch_search)


@pytest.mark.parametrize("flag", list(SEARCH_FLAGS))
def test_search_flags_predict_what_jax_cli_predicts(jax_store, flag, monkeypatch):
    """``--do_predict`` with each search or speculation flag writes the same
    ``predictions.jsonl`` as JAX's CLI on the same arguments and store (the
    fresh LoRA has B = 0 in both).  Speculation's tokens, recorded on both
    sides, are compared up to each row's first near-tie (top-2 logits within
    LOGIT_TIE, teacher-forced through the port's forward), as
    test_torch_speculative does; the lines of rows equal in full are equal."""
    import qlora_tpu.generate.speculative as jspeculative

    tmp, store, data = jax_store
    kw = dict(model_name_or_path=store, fake_tokenizer=True, dataset=data, do_train=False,
              do_eval=False, do_predict=True, lora_r=4, eval_dataset_size=4,
              max_eval_samples=4, per_device_eval_batch_size=2, source_max_len=48,
              target_max_len=24, max_new_tokens=6, **SEARCH_FLAGS[flag])
    made = {"jax": [], "port": []}
    def recording(mod, tag):
        real = mod.generate_speculative

        def generate_speculative(*a, **k):
            made[tag].append((np.asarray(a[2]), np.asarray(a[3]), real(*a, **k)))
            return made[tag][-1][2]

        monkeypatch.setattr(mod, "generate_speculative", generate_speculative)

    recording(jspeculative, "jax")
    recording(tgenerate, "port")
    outs = []
    for mod, extra in ((jcli, {}), (cli, {"device": "cpu"})):
        out = str(tmp / f"{flag}-{mod.__name__}")
        mod.train(mod.Args(output_dir=out, **kw, **extra))
        outs.append(open(os.path.join(out, "predictions.jsonl")).read().splitlines())
    assert len(outs[1]) == len(outs[0]) == 4
    if flag != "predict_speculative":
        assert outs[1] == outs[0]
        return
    params, _ = load_quantized(store, device="cpu")
    cfg = get_config("debug")
    rows, compared = 0, 0
    for (ids, lengths, want), (_, _, got) in zip(made["jax"], made["port"]):
        want, got = np.asarray(want), got.numpy()
        for b in range(min(2, 4 - rows)):
            prompt = ids[b, :lengths[b]].tolist()
            seq = torch.tensor([prompt + want[b].tolist()])
            with torch.inference_mode():
                logits = forward(params, None, seq, cfg)[0][0, len(prompt) - 1:-1]
            top2 = logits.topk(2, dim=-1).values
            ties = ((top2[:, 0] - top2[:, 1]) <= LOGIT_TIE).nonzero()
            upto = int(ties[0]) if len(ties) else want.shape[1]
            assert got[b, :upto].tolist() == want[b, :upto].tolist(), (b, upto)
            if (got[b] == want[b]).all():
                assert outs[1][rows] == outs[0][rows]
            compared += upto
            rows += 1
    assert rows == 4 and compared > 0


@pytest.mark.parametrize("extra", [dict(num_beams=2), dict(penalty_alpha=0.6),
                                   dict(min_new_tokens=2)])
def test_speculation_with_beams_or_contrastive_raises(jax_store, extra):
    tmp, store, data = jax_store
    args = cli.Args(model_name_or_path=store, fake_tokenizer=True, dataset=data,
                    output_dir=str(tmp / "refused"), device="cpu", do_train=False,
                    do_predict=True, eval_dataset_size=4, max_eval_samples=4,
                    predict_speculative=3, **extra)
    with pytest.raises(ValueError, match="predict_speculative"):
        cli.train(args)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is present")
def test_no_device_and_no_cuda_raises(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.train(cli.Args(output_dir=str(tmp_path / "out")))


@pytest.mark.parametrize("shape", [(2, 71), (2, 2, 71), (2, 72)])
def test_pad_to_sp_multiple(shape):
    """``--mesh_sp``: a batch whose length is no multiple of sp gets right
    pads (ids 0, labels -100, mask 0) up to the next multiple, as JAX's CLI
    pads it; a multiple is left as it is."""
    ids = np.arange(np.prod(shape)).reshape(shape) % 50 + 1
    batch = {"input_ids": ids, "labels": ids.copy(), "attention_mask": np.ones_like(ids)}
    out = cli._pad_to(batch, 2)
    S = shape[-1] + shape[-1] % 2
    assert all(v.shape == shape[:-1] + (S,) for v in out.values())
    np.testing.assert_array_equal(out["input_ids"][..., :shape[-1]], ids)
    if S > shape[-1]:
        assert (out["labels"][..., -1] == -100).all() and (out["input_ids"][..., -1] == 0).all()
        assert (out["attention_mask"][..., -1] == 0).all()
    else:
        assert out is batch
