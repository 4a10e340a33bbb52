"""The GPT judge's command line (the QLoRA reference's
eval/eval_gpt_review.py), on the port's ``eval.judge``.

The bundled Vicuna banks under ``eval/prompts/`` of the repository are the
defaults, so only the two answer files are required:

  python -m qlora_tpu_torch.scripts.run_judge \\
      --answers1 generations_a.jsonl --answers2 generations_b.jsonl \\
      --mode threeclass --output ratings.jsonl --judge-model gpt-4
"""

from __future__ import annotations

import argparse
from pathlib import Path

from qlora_tpu_torch.eval.judge import dump_jsonl, load_jsonl, run_judge

BANKS = Path(__file__).resolve().parents[2] / "eval" / "prompts"


def make_openai_chat(model: str):
    import openai  # any OpenAI-compatible endpoint works

    client = openai.OpenAI()

    def chat(system_prompt: str, user_prompt: str, max_tokens: int) -> str:
        resp = client.chat.completions.create(
            model=model,
            messages=[
                {"role": "system", "content": system_prompt},
                {"role": "user", "content": user_prompt},
            ],
            temperature=0.2,           # eval_gpt_review.py:37
            max_tokens=max_tokens,
        )
        return resp.choices[0].message.content

    return chat


def parse_args(argv=None):
    ap = argparse.ArgumentParser("qlora_tpu_torch.scripts.run_judge")
    ap.add_argument("--questions", default=str(BANKS / "vicuna_questions.jsonl"))
    ap.add_argument("--answers1", required=True)
    ap.add_argument("--answers2", required=True)
    ap.add_argument("--reviewers", default=str(BANKS / "reviewer.jsonl"))
    ap.add_argument("--prompts", default=str(BANKS / "vicuna_prompt_threeclass.jsonl"))
    ap.add_argument("--mode", choices=["threeclass", "relative"], default="threeclass")
    ap.add_argument("--output", required=True)
    ap.add_argument("--api", default="openai")
    ap.add_argument("--judge-model", default="gpt-4")
    ap.add_argument("--max-tokens", type=int, default=1024)
    ap.add_argument("--max-workers", type=int, default=8)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    chat_fn = make_openai_chat(args.judge_model)
    results = run_judge(
        load_jsonl(args.questions),
        load_jsonl(args.answers1),
        load_jsonl(args.answers2),
        load_jsonl(args.reviewers),
        load_jsonl(args.prompts),
        chat_fn,
        mode=args.mode,
        max_tokens=args.max_tokens,
        max_workers=args.max_workers,
    )
    dump_jsonl(results, args.output)
    print(f"wrote {len(results)} reviews to {args.output}")


if __name__ == "__main__":
    main()
