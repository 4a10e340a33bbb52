"""The port's scripts (``qlora_tpu_torch/scripts``) against the JAX
package's: each shell recipe's arguments parsed by the port's CLI equal to
the JAX recipe's parsed by JAX's CLI, field for field; the checkpoint
converter's store loading in both packages; ``run_judge.main`` writing the
same jsonl as JAX's with the same stub in place of the OpenAI client."""

import dataclasses
import importlib.util
import shlex
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from qlora_tpu import cli as jcli
from qlora_tpu.quant.blockwise import dequantize as jdequantize
from qlora_tpu.utils import quantized_store as jqs
from qlora_tpu.utils.hf_import import load_hf_model as jload_hf_model

from qlora_tpu_torch import cli as tcli
from qlora_tpu_torch.scripts import convert_checkpoint, run_judge
from qlora_tpu_torch.utils import load_hf_model, load_quantized
from test_torch_judge import stub_judge

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
RECIPES = ("finetune", "finetune_guanaco_7b", "finetune_guanaco_13b", "finetune_guanaco_33b",
           "finetune_guanaco_65b", "finetune_llama2_guanaco_7b", "generate",
           "finetune_longcontext_sp")


def recipe(path):
    """(module, argv) of the ``python -m`` line of a shell recipe."""
    lines = [ln for ln in path.read_text().replace("\\\n", " ").splitlines()
             if ln.strip() and not ln.lstrip().startswith("#")]
    (words,) = [shlex.split(ln) for ln in lines if ln.lstrip().startswith("python")]
    assert words[:2] == ["python", "-m"]
    return words[2], words[3:]


def load_script(name):
    """A JAX script, loaded by path."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_recipe_is_ported():
    names = {p.stem for p in (ROOT / "qlora_tpu_torch" / "scripts").glob("*.sh")}
    assert names == set(RECIPES)


@pytest.mark.parametrize("name", RECIPES)
def test_recipe_parses_to_jax_s_args(name):
    tmod, targv = recipe(ROOT / "qlora_tpu_torch" / "scripts" / f"{name}.sh")
    jmod, jargv = recipe(ROOT / "scripts" / f"{name}.sh")
    assert (tmod, jmod) == ("qlora_tpu_torch.cli", "qlora_tpu.cli")
    assert targv == jargv
    got, want = tcli.parse_args(targv), jcli.parse_args(jargv)
    common = {f.name for f in dataclasses.fields(got)} & {f.name for f in dataclasses.fields(want)}
    assert len(common) > 80
    assert {k: getattr(got, k) for k in common} == {k: getattr(want, k) for k in common}
    tcli.check_supported(got)              # nothing the recipe asks for is missing


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    d = tmp_path_factory.mktemp("hf_llama")
    torch.manual_seed(0)
    cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=256, intermediate_size=384, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
        rms_norm_eps=1e-5, tie_word_embeddings=False)
    transformers.LlamaForCausalLM(cfg).eval().save_pretrained(d)
    return str(d)


def leaves(tree, prefix=""):
    """{path: tensor} over a port params tree (QLinear, QuantizedTensor and
    DenseLinear are dataclasses)."""
    if dataclasses.is_dataclass(tree):
        tree = {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in leaves(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in leaves(sub, f"{prefix}/{i}").items()}
    return {prefix: tree} if isinstance(tree, torch.Tensor) else {}


@pytest.mark.parametrize("flags", [[], ["--quant_type", "fp4", "--no-double-quant"]],
                         ids=["nf4_dq", "fp4"])
def test_converted_store_is_the_in_process_import(hf_dir, tmp_path, capsys, flags):
    dst = str(tmp_path / "store")
    convert_checkpoint.main(["--src", hf_dir, "--dst", dst, "--device", "cpu"] + flags)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("quantized in ") and out[1] == f"wrote {dst}"
    quant_type = "fp4" if flags else "nf4"
    want, wcfg = load_hf_model(hf_dir, quant_type=quant_type, double_quant=not flags,
                               device="cpu")
    got, gcfg = load_quantized(dst, device="cpu")
    assert gcfg == wcfg
    got, want = leaves(got), leaves(want)
    assert got.keys() == want.keys() and len(got) > 20
    for k in want:           # tolerance 0: every tensor byte for byte
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_converted_store_loads_in_jax(hf_dir, tmp_path):
    """``python -m qlora_tpu_torch.scripts.convert_checkpoint``'s store read by
    JAX's loader: the packed nibbles and every dense leaf equal to JAX's own
    import of the checkpoint, each dequantized weight within max |w| / 127
    of it (one int8 absmax code step over its tensor's largest block: the
    double quant's mean offset is a float reduction whose last bit depends
    on summation order, ROADMAP's double-quant note, which may move a code
    by one)."""
    dst = str(tmp_path / "store")
    r = subprocess.run([sys.executable, "-m", "qlora_tpu_torch.scripts.convert_checkpoint",
                        "--src", hf_dir, "--dst", dst, "--device", "cpu"],
                       capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    got, gcfg = jqs.load_quantized(dst)
    want, wcfg = jload_hf_model(hf_dir, quantize_base=True)
    assert gcfg == wcfg
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        for layer in range(wcfg.num_layers):
            g, w = (jax.tree_util.tree_map(lambda a: a[layer], t["blocks"][name].qt)
                    for t in (got, want))
            step = np.abs(np.asarray(jdequantize(w, np.float32))).max() / 127
            dg, dw = (np.asarray(jdequantize(q, np.float32)) for q in (g, w))
            assert np.abs(dg - dw).max() <= step, (name, layer)
            assert np.array_equal(np.asarray(g.packed), np.asarray(w.packed))
    for k in ("embed", "final_norm"):
        for a, b in zip(jax.tree_util.tree_leaves(got[k]), jax.tree_util.tree_leaves(want[k])):
            assert np.array_equal(np.asarray(a), np.asarray(b)), k


def test_run_judge_writes_jax_s_jsonl(tmp_path, monkeypatch, capsys):
    from qlora_tpu_torch.eval.judge import dump_jsonl, load_jsonl

    questions = load_jsonl(str(ROOT / "eval" / "prompts" / "vicuna_questions.jsonl"))
    for i, tag, rows in ((1, "first", questions[:-10]), (2, "second", questions[5:])):
        dump_jsonl([{"question_id": q["question_id"], "text": f"{tag}: {q['text'][::-1]}"}
                    for q in rows], str(tmp_path / f"a{i}.jsonl"))
    jscript = load_script("run_judge")
    for mod in (run_judge, jscript):
        monkeypatch.setattr(mod, "make_openai_chat", lambda model: stub_judge)
    for mode in ("threeclass", "relative"):
        argv = ["--answers1", str(tmp_path / "a1.jsonl"), "--answers2", str(tmp_path / "a2.jsonl"),
                "--mode", mode, "--max-tokens", "77", "--max-workers", "3"]
        if mode == "relative":
            argv += ["--prompts", str(ROOT / "eval" / "prompts" / "vicuna_prompt_relative.jsonl")]
        run_judge.main(argv + ["--output", str(tmp_path / f"port_{mode}.jsonl")])
        monkeypatch.setattr(sys, "argv", ["run_judge.py"] + argv
                            + ["--output", str(tmp_path / f"jax_{mode}.jsonl")])
        jscript.main()
        port = (tmp_path / f"port_{mode}.jsonl").read_bytes()
        assert port == (tmp_path / f"jax_{mode}.jsonl").read_bytes()
        rows = load_jsonl(str(tmp_path / f"port_{mode}.jsonl"))
        assert [r["question_id"] for r in rows] == [q["question_id"] for q in questions[5:-10]]
        assert capsys.readouterr().out.splitlines() == [
            f"wrote {len(rows)} reviews to {tmp_path / f'{who}_{mode}.jsonl'}"
            for who in ("port", "jax")]
    assert run_judge.parse_args(["--answers1", "a", "--answers2", "b", "--output", "o"]).questions \
        == str(ROOT / "eval" / "prompts" / "vicuna_questions.jsonl")
