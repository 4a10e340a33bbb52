"""Baseline answer generation for benchmark questions.

The port's copy of the JAX package's ``eval/baseline.py`` (the QLoRA
reference's ``eval/qa_baseline_gpt.py``): answers from any `chat_fn` for a
question bank, thread-pooled with bounded retries, in the same jsonl schema
(question_id / text / answer_id / model_id).  Standard library only.
"""

from __future__ import annotations

import concurrent.futures
import logging
import time
import uuid
from typing import Callable

logger = logging.getLogger(__name__)

MAX_RETRY = 3          # qa_baseline_gpt.py:24
DEFAULT_MODEL_ID = "baseline"


def get_answer(
    chat_fn: Callable[[str, int], str],
    question: dict,
    max_tokens: int = 1024,
    max_retry: int = MAX_RETRY,
) -> dict:
    """One answer with retries (qa_baseline_gpt.py:24-43); text "#ERROR#"
    when every try raised."""
    ans = {
        "answer_id": uuid.uuid4().hex[:22],
        "question_id": question["question_id"],
        "model_id": question.get("model_id", DEFAULT_MODEL_ID),
    }
    for i in range(max_retry):
        try:
            ans["text"] = chat_fn(question["text"], max_tokens)
            return ans
        except Exception as e:
            logger.warning("baseline API error %s (retry %d)", e, i + 1)
            time.sleep(1)
    ans["text"] = "#ERROR#"
    return ans


def generate_baseline_answers(
    questions: list[dict],
    chat_fn: Callable[[str, int], str],
    *,
    max_tokens: int = 1024,
    max_workers: int = 32,   # qa_baseline_gpt.py:68 pool size
) -> list[dict]:
    """One answer a question, in question-id order."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=max_workers) as ex:
        futs = {
            ex.submit(get_answer, chat_fn, q, max_tokens): q["question_id"]
            for q in questions
        }
        out = [f.result() for f in concurrent.futures.as_completed(futs)]
    out.sort(key=lambda a: a["question_id"])
    return out
