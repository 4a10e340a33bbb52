"""Evaluation: MMLU rank classification (the GPT judge and the baseline
answers are a later slice of the port)."""

from .mmlu import abcd_token_ids, evaluate_mmlu, load_mmlu_file, mmlu_batch

__all__ = ["abcd_token_ids", "evaluate_mmlu", "load_mmlu_file", "mmlu_batch"]
