"""Evaluation: MMLU rank classification, the GPT judge harness and the
baseline answers it rates."""

from .baseline import generate_baseline_answers
from .judge import gen_prompt, parse_score_pair, parse_three_class_score, run_judge
from .mmlu import abcd_token_ids, evaluate_mmlu, load_mmlu_file, mmlu_batch

__all__ = [
    "abcd_token_ids", "evaluate_mmlu", "load_mmlu_file", "mmlu_batch",
    "run_judge", "gen_prompt", "parse_score_pair", "parse_three_class_score",
    "generate_baseline_answers",
]
