"""Guanaco inference: the QLoRA reference's examples/guanaco_generate.py on
the port.

Loads a base model NF4-quantized and a trained LoRA adapter checkpoint, then
samples a reply to one prompt in the Guanaco ``### Human: / ### Assistant:``
format.  Sampling draws from a ``torch.Generator`` seeded by ``--seed``
(the JAX example's ``PRNGKey``: the same seed samples other tokens there).

  python -m qlora_tpu_torch.examples.guanaco_generate \\
      --model_path /path/to/hf/llama-7b \\
      --adapter_path ./output  (checkpoint dir; latest checkpoint is used) \\
      --prompt "Tell me about gravitation." \\
      --max_new_tokens 512 --top_p 0.9 --temperature 0.7
"""

from __future__ import annotations

import argparse

import torch

from qlora_tpu_torch import resolve_device
from qlora_tpu_torch.examples import _load
from qlora_tpu_torch.generate import SamplingParams, generate
from qlora_tpu_torch.lora import LoraConfig

PROMPT_TEMPLATE = "### Human: {user_question}### Assistant:"

load_model = _load.load_hf
load_tokenizer = _load.load_tokenizer


def parse_args(argv=None):
    ap = argparse.ArgumentParser("qlora_tpu_torch.examples.guanaco_generate")
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--adapter_path", default=None)
    ap.add_argument("--prompt", default="Tell me about alpacas.")
    ap.add_argument("--max_new_tokens", type=int, default=512)
    ap.add_argument("--top_p", type=float, default=0.9)
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--lora_r", type=int, default=64)
    ap.add_argument("--lora_alpha", type=float, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--decode_impl", default=None, choices=[None, "int8"],
                    help="int8: decode through a per-column int8 serving copy and "
                         "the direct int8 decode kernels (the prefill stays exact)")
    ap.add_argument("--device", default=None, help="CUDA unless given (cpu: the plain path)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    params, cfg = load_model(args.model_path, device)
    tokenizer = load_tokenizer(args.model_path)

    lora = None
    lcfg = LoraConfig(r=args.lora_r, alpha=args.lora_alpha)
    if args.adapter_path:
        lora, ckpt = _load.load_adapter(args.adapter_path, cfg, lcfg, device)
        print(f"loaded adapter from {ckpt}")

    text = PROMPT_TEMPLATE.format(user_question=args.prompt)
    ids = [tokenizer.bos_token_id] + tokenizer.encode(text)
    toks = generate(
        params, lora, torch.tensor([ids]), torch.tensor([len(ids)]), cfg, lcfg,
        max_new_tokens=args.max_new_tokens,
        eos_id=tokenizer.eos_token_id,
        sparams=SamplingParams(do_sample=True, temperature=args.temperature, top_p=args.top_p),
        generator=torch.Generator(device=device).manual_seed(args.seed),
        decode_impl=args.decode_impl,
        device=device,
    )
    out = [t for t in toks[0].tolist() if t != tokenizer.eos_token_id]
    print(tokenizer.decode(out))


if __name__ == "__main__":
    main()
