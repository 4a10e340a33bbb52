"""GPT judge harness: automated pairwise or relative answer rating.

The port's copy of the JAX package's ``eval/judge.py``, with the same jsonl
formats, category routing and retry semantics (the QLoRA reference's
``eval/eval_gpt_review.py``), ``concurrent.futures`` in place of Ray.  It
needs only the standard library: the chat function that reaches a model is
the caller's.

Two rating modes:
* "threeclass": pairwise win / lose / tie; the parser reads the last line
  (parse_three_class_score);
* "relative": two scores out of 10 on the first line (parse_score_pair).
"""

from __future__ import annotations

import concurrent.futures
import json
import logging
import time
from typing import Callable

logger = logging.getLogger(__name__)

MAX_API_RETRY = 1000          # eval_gpt_review.py:21
REQ_TIME_GAP = 2              # eval_gpt_review.py:22


def load_jsonl(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def dump_jsonl(rows: list[dict], path: str) -> None:
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def parse_score_pair(review: str) -> list[float]:
    """First line 'x y' → [x, y]; [-1, -1] on failure (eval_gpt_review.py:61-74)."""
    try:
        pair = review.split("\n")[0].replace(",", " ").split()
        if len(pair) == 2:
            return [float(pair[0]), float(pair[1])]
        raise ValueError
    except Exception:
        logger.error("Invalid score pair: %r", review[:100])
        return [-1.0, -1.0]


def parse_three_class_score(review: str) -> int:
    """Last line an int in {0, 1, 2} → win / lose / tie; -1 on failure
    (eval_gpt_review.py:51-59)."""
    try:
        score = int(review.strip().split("\n")[-1].strip())
        if score in (0, 1, 2):
            return score
        raise ValueError
    except Exception:
        logger.error("Invalid three-class score: %r", review[-100:])
        return -1


def gen_prompt(
    reviewer_jsons: list[dict],
    prompt_jsons: list[dict],
    cat: str,
    ques: str,
    ans1: str,
    ans2: str,
) -> tuple[str, str, int, int]:
    """Category-routed prompt construction (eval_gpt_review.py:77-95): the
    first reviewer of category `cat`, else the first reviewer.

    Returns (system_prompt, full_prompt, reviewer_id, prompt_id).
    """
    reviewer_idx = 0
    for idx, reviewer in enumerate(reviewer_jsons):
        if reviewer["category"] == cat:
            reviewer_idx = idx
            break
    prompt_id = reviewer_jsons[reviewer_idx]["prompt_id"]
    prompt_json = next(p for p in prompt_jsons if p["prompt_id"] == prompt_id)
    sys_prompt = prompt_json["system_prompt"]
    prompt_template = prompt_json["prompt_template"]
    defaults = prompt_json["defaults"]
    prompt = prompt_template.format(
        question=ques, answer_1=ans1, answer_2=ans2, **defaults
    )
    return sys_prompt, prompt, reviewer_idx + 1, prompt_id


def get_eval(
    chat_fn: Callable[[str, str, int], str],
    sys_prompt: str,
    user_prompt: str,
    max_tokens: int,
    max_retry: int = MAX_API_RETRY,
) -> str:
    """Retry wrapper with capped linear backoff (eval_gpt_review.py:28-48).

    `chat_fn(system, user, max_tokens) -> str` reaches the judge model.
    Every exception it raises is retried, after min(5 (i + 1), 100) s, so a
    chat function that should end a run at once must not raise.
    """
    for i in range(max_retry):
        try:
            return chat_fn(sys_prompt, user_prompt, max_tokens)
        except Exception as e:  # rate limits / transient API errors
            logger.warning("judge API error (%s); retry %d", e, i + 1)
            time.sleep(min(5 * (i + 1), 100))
    raise RuntimeError(f"judge API failed after {max_retry} retries")


def run_judge(
    question_rows: list[dict],
    answer1_rows: list[dict],
    answer2_rows: list[dict],
    reviewer_rows: list[dict],
    prompt_rows: list[dict],
    chat_fn: Callable[[str, str, int], str],
    *,
    mode: str = "threeclass",
    max_tokens: int = 1024,
    max_workers: int = 8,
    req_gap_s: float = 0.0,
) -> list[dict]:
    """A judge run over aligned question and answer files
    (eval_gpt_review.py:106-216): one review row a question id present in
    all three, in question-id order."""
    q_by_id = {q["question_id"]: q for q in question_rows}
    a1_by_id = {a["question_id"]: a for a in answer1_rows}
    a2_by_id = {a["question_id"]: a for a in answer2_rows}
    ids = sorted(set(q_by_id) & set(a1_by_id) & set(a2_by_id))

    jobs = []
    for qid in ids:
        q = q_by_id[qid]
        ans1, ans2 = a1_by_id[qid], a2_by_id[qid]
        cat = q.get("category", "general")
        sys_prompt, prompt, reviewer_id, prompt_id = gen_prompt(
            reviewer_rows, prompt_rows, cat, q["text"],
            ans1.get("text", ans1.get("answer", "")),
            ans2.get("text", ans2.get("answer", "")),
        )
        jobs.append((qid, cat, sys_prompt, prompt, reviewer_id, prompt_id))

    results = []
    with concurrent.futures.ThreadPoolExecutor(max_workers=max_workers) as ex:
        futs = []
        for qid, cat, sys_prompt, prompt, reviewer_id, prompt_id in jobs:
            futs.append(
                (qid, cat, reviewer_id, prompt_id,
                 ex.submit(get_eval, chat_fn, sys_prompt, prompt, max_tokens))
            )
            if req_gap_s:
                time.sleep(req_gap_s)
        for qid, cat, reviewer_id, prompt_id, fut in futs:
            review = fut.result()
            if mode == "threeclass":
                score = parse_three_class_score(review)
            else:
                score = parse_score_pair(review)
            results.append({
                "question_id": qid,
                "category": cat,
                "reviewer_id": reviewer_id,
                "prompt_id": prompt_id,
                "review": review,
                "score": score,
            })
    return results
