"""The port's GPT judge harness and baseline answers (``qlora_tpu_torch.eval``)
against the JAX package's, with the same deterministic stub chat functions
in both: the parsers on edge cases, category routing over the bundled
prompt banks, whole judge runs in both modes, retries with the sleeps
recorded instead of slept, and the jsonl round trip.  The NF4 codebook's
derivation against JAX's and against the pinned table."""

import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from qlora_tpu.eval import baseline as jbaseline
from qlora_tpu.eval import judge as jjudge
from qlora_tpu.quant.codebooks import derive_nf4_codebook as jderive

from qlora_tpu_torch.eval import baseline as tbaseline
from qlora_tpu_torch.eval import judge as tjudge
from qlora_tpu_torch.quant.codebooks import NF4_CODE, derive_nf4_codebook

BANKS = Path(__file__).resolve().parents[1] / "eval" / "prompts"
QUESTIONS = jjudge.load_jsonl(str(BANKS / "vicuna_questions.jsonl"))
PROMPT_BANKS = {"vicuna_threeclass": ("reviewer.jsonl", "vicuna_prompt_threeclass.jsonl"),
                "vicuna_relative": ("reviewer.jsonl", "vicuna_prompt_relative.jsonl"),
                "oa_threeclass": ("oa_reviewer.jsonl", "oa_prompt_threeclass.jsonl")}

REVIEWS = [
    "7 9\nbecause...", "7,9\nx", "7, 9", " 8.5 6 \nfine", "10 10", "garbage", "", "\n7 9",
    "7 9 10\nthree numbers", "7\nonly one", "seven nine", "1e1 -2", "nan inf",
    "reasoning...\n1", "2", "0", "text\n7", "text\n-1", "text\n 2 \n", "a\nb\n1\n\n",
    "1.0", "x\n٢", "Assistant 1 wins.\n1", "tie\n2\ntrailing", "\n\n\n",
]


def banks(name):
    reviewers, prompts = PROMPT_BANKS[name]
    return jjudge.load_jsonl(str(BANKS / reviewers)), jjudge.load_jsonl(str(BANKS / prompts))


def stub_judge(sys_prompt, user_prompt, max_tokens):
    """A deterministic review: scores from the prompts' lengths, and a last
    line that is a valid three-class score for some prompts only."""
    last = len(user_prompt) % 5 - 1          # -1 .. 3: -1 and 3 fail the parser
    return f"{len(sys_prompt) % 11} {len(user_prompt) % 10}\nreview of {max_tokens}\n{last}"


def stub_answer(text, max_tokens):
    return f"an answer of at most {max_tokens} tokens to: {text[::-1][:40]}"


def answers(tag):
    return [{"question_id": q["question_id"], "text": f"{tag} {q['text'][:30]}"}
            for q in QUESTIONS]


@pytest.mark.parametrize("review", REVIEWS)
def test_parsers_match_jax(review):
    # repr: "nan" parses to a float that equals nothing, itself included
    assert repr(tjudge.parse_score_pair(review)) == repr(jjudge.parse_score_pair(review))
    assert tjudge.parse_three_class_score(review) == jjudge.parse_three_class_score(review)


def test_parsers_read_their_lines():
    assert tjudge.parse_score_pair("7,9\nx") == [7.0, 9.0]
    assert tjudge.parse_score_pair("garbage") == [-1.0, -1.0]
    assert tjudge.parse_three_class_score("reasoning...\n1") == 1
    assert tjudge.parse_three_class_score("text\n7") == -1


@pytest.mark.parametrize("bank", sorted(PROMPT_BANKS))
def test_gen_prompt_routes_every_category_as_jax(bank):
    reviewers, prompts = banks(bank)
    cats = sorted({q["category"] for q in QUESTIONS}) + ["not-a-category"]
    for cat in cats:
        q = next((q for q in QUESTIONS if q["category"] == cat), QUESTIONS[0])
        got = tjudge.gen_prompt(reviewers, prompts, cat, q["text"], "first", "second")
        assert got == jjudge.gen_prompt(reviewers, prompts, cat, q["text"], "first", "second")
        want_idx = next((i for i, r in enumerate(reviewers) if r["category"] == cat), 0)
        assert got[2:] == (want_idx + 1, reviewers[want_idx]["prompt_id"])
        assert q["text"] in got[1] and "first" in got[1] and "second" in got[1]


@pytest.mark.parametrize("bank,mode", [("vicuna_threeclass", "threeclass"),
                                       ("vicuna_relative", "relative"),
                                       ("oa_threeclass", "threeclass")])
def test_run_judge_matches_jax_row_for_row(bank, mode):
    reviewers, prompts = banks(bank)
    args = (QUESTIONS, answers("first"), answers("second")[5:], reviewers, prompts, stub_judge)
    got = tjudge.run_judge(*args, mode=mode, max_tokens=64, max_workers=4)
    want = jjudge.run_judge(*args, mode=mode, max_tokens=64, max_workers=4)
    assert got == want
    assert [r["question_id"] for r in got] == [q["question_id"] for q in QUESTIONS[5:]]
    parse = tjudge.parse_three_class_score if mode == "threeclass" else tjudge.parse_score_pair
    assert all(r["score"] == parse(r["review"]) for r in got)
    if mode == "threeclass":        # parsed scores and failed ones (-1) both occur
        assert {r["score"] for r in got} == {-1, 0, 1, 2}


def recorded_sleeps(monkeypatch):
    slept = []
    monkeypatch.setattr(time, "sleep", slept.append)
    return slept


def flaky(failures, result):
    calls = []

    def chat(*a):
        calls.append(a)
        if len(calls) <= failures:
            raise RuntimeError("rate limit")
        return result
    return chat, calls


@pytest.mark.parametrize("failures,max_retry", [(0, 3), (2, 5), (25, 30), (3, 3)])
def test_get_eval_retries_as_jax(monkeypatch, failures, max_retry):
    slept = recorded_sleeps(monkeypatch)
    outs = []
    for mod in (tjudge, jjudge):
        chat, calls = flaky(failures, "ok\n2")
        try:
            outs.append((mod.get_eval(chat, "s", "u", 10, max_retry=max_retry), len(calls)))
        except RuntimeError as e:
            outs.append((str(e), len(calls)))
    assert outs[0] == outs[1]
    assert slept[:len(slept) // 2] == slept[len(slept) // 2:]
    tries = min(failures, max_retry)
    assert slept[:tries] == [min(5 * (i + 1), 100) for i in range(tries)]
    assert tjudge.MAX_API_RETRY == jjudge.MAX_API_RETRY == 1000


@pytest.mark.parametrize("failures", [0, 2, 3])
def test_baseline_answer_retries_and_error_as_jax(monkeypatch, failures):
    slept = recorded_sleeps(monkeypatch)
    got = []
    for mod in (tbaseline, jbaseline):
        chat, calls = flaky(failures, "an answer")
        ans = mod.get_answer(chat, {"question_id": 7, "text": "q?"}, max_tokens=9)
        got.append(({k: v for k, v in ans.items() if k != "answer_id"}, len(calls)))
        assert len(ans["answer_id"]) == 22
    assert got[0] == got[1]
    assert got[0][0]["text"] == ("#ERROR#" if failures >= 3 else "an answer")
    assert slept == [1] * min(failures, 3) * 2


def test_generate_baseline_answers_match_jax_but_for_answer_id():
    questions = QUESTIONS[::-1][:40]
    got = tbaseline.generate_baseline_answers(questions, stub_answer, max_tokens=32,
                                              max_workers=8)
    want = jbaseline.generate_baseline_answers(questions, stub_answer, max_tokens=32,
                                               max_workers=8)
    strip = lambda rows: [{k: v for k, v in r.items() if k != "answer_id"} for r in rows]
    assert strip(got) == strip(want)
    assert [a["question_id"] for a in got] == sorted(q["question_id"] for q in questions)
    assert len({a["answer_id"] for a in got}) == len(got)


def test_generate_baseline_answers_run_concurrently():
    """max_workers chat calls are in flight at once: each waits at a
    barrier of 4 (with fewer in flight it breaks, and the answers turn
    "#ERROR#")."""
    barrier = threading.Barrier(4, timeout=10)

    def meet(text, max_tokens):
        barrier.wait()
        return text

    out = tbaseline.generate_baseline_answers(QUESTIONS[:8], meet, max_workers=4)
    assert [a["text"] for a in out] == [q["text"] for q in QUESTIONS[:8]]


def test_jsonl_round_trip_reads_in_both(tmp_path):
    rows = tjudge.run_judge(QUESTIONS[:6], answers("a"), answers("b"), *banks("vicuna_relative"),
                            stub_judge, mode="relative")
    rows.append({"question_id": 99, "review": "ünïcode ✓\nline", "score": [1.5, -1.0]})
    tjudge.dump_jsonl(rows, str(tmp_path / "t.jsonl"))
    jjudge.dump_jsonl(rows, str(tmp_path / "j.jsonl"))
    assert (tmp_path / "t.jsonl").read_bytes() == (tmp_path / "j.jsonl").read_bytes()
    assert tjudge.load_jsonl(str(tmp_path / "j.jsonl")) == rows
    assert jjudge.load_jsonl(str(tmp_path / "t.jsonl")) == rows
    (tmp_path / "gaps.jsonl").write_text('\n{"a": 1}\n\n  \n{"b": 2}\n')
    assert tjudge.load_jsonl(str(tmp_path / "gaps.jsonl")) == [{"a": 1}, {"b": 2}]


def test_eval_package_exports_jax_names():
    import qlora_tpu.eval as jeval
    import qlora_tpu_torch.eval as teval

    for name in ("run_judge", "gen_prompt", "parse_score_pair", "parse_three_class_score",
                 "generate_baseline_answers"):
        assert name in jeval.__all__ and name in teval.__all__
        assert getattr(teval, name).__module__.startswith("qlora_tpu_torch.eval.")


def test_derived_nf4_codebook_matches_jax_and_the_table():
    got = derive_nf4_codebook()
    want = jderive()
    assert got.dtype == want.dtype == np.float32 and got.shape == (16,)
    assert got.tobytes() == want.tobytes()
    np.testing.assert_allclose(got, NF4_CODE, atol=1e-6, rtol=0)
    assert got[7] == 0.0 and got[0] == -1.0 and got[-1] == 1.0
