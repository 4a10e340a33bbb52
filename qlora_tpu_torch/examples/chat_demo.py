"""Streaming multi-turn chat in the terminal: the QLoRA reference's Gradio
Colab demo (examples/guanaco_7B_demo_colab.ipynb) on the port.  The
history flattens to ``### Human: / ### Assistant:`` turns, the reply
streams token by token, and it stops at EOS.

Each reply samples from a ``torch.Generator`` seeded 0 (the JAX demo's
default ``PRNGKey(0)``: the same seed samples other tokens there).

  python -m qlora_tpu_torch.examples.chat_demo --model_path /path/to/hf/llama-7b \\
      [--adapter_path ./output] [--decode_impl int8] [--speculative 4]
"""

from __future__ import annotations

import argparse

import torch

from qlora_tpu_torch import resolve_device
from qlora_tpu_torch.examples import _load
from qlora_tpu_torch.generate import SamplingParams, generate_stream, generate_stream_speculative
from qlora_tpu_torch.lora import LoraConfig

load_model = _load.load_hf
load_tokenizer = _load.load_tokenizer


def build_prompt(history):
    """Flatten turns like the demo notebook's Gradio callback (cell 2)."""
    parts = []
    for user, assistant in history:
        parts.append(f"### Human: {user}### Assistant: {assistant}")
    return "".join(parts)


def parse_args(argv=None):
    ap = argparse.ArgumentParser("qlora_tpu_torch.examples.chat_demo")
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--adapter_path", default=None)
    ap.add_argument("--max_new_tokens", type=int, default=512)
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--top_p", type=float, default=0.9)
    ap.add_argument("--decode_impl", default=None, choices=[None, "int8"],
                    help="int8: the token loop through the direct int8 decode kernels "
                         "(the prefill stays exact)")
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="prompt-lookup speculative decoding with K-token drafts (0 = off): "
                         "each verify chunk retires 1..K+1 tokens; sampled outputs stay "
                         "exactly distributed through rejection sampling")
    ap.add_argument("--device", default=None, help="CUDA unless given (cpu: the plain path)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    params, cfg = load_model(args.model_path, device)
    tokenizer = load_tokenizer(args.model_path)
    decode_params = None
    if args.decode_impl == "int8":
        # the serving copy, built once and reused across turns
        from qlora_tpu_torch.generate.serve_int8 import requantize_params_int8_unstacked

        with torch.no_grad():
            decode_params = requantize_params_int8_unstacked(params)
    lcfg = LoraConfig()
    lora = None
    if args.adapter_path:
        lora, _ = _load.load_adapter(args.adapter_path, cfg, lcfg, device)

    sp = SamplingParams(do_sample=True, temperature=args.temperature, top_p=args.top_p)
    history = []
    print("Chat ready — empty line to quit.")
    while True:
        try:
            user = input("you> ").strip()
        except EOFError:
            break
        if not user:
            break
        history.append((user, ""))
        prompt = build_prompt(history)
        ids = [tokenizer.bos_token_id] + tokenizer.encode(prompt)
        reply_ids = []
        print("bot> ", end="", flush=True)
        kw = dict(max_new_tokens=args.max_new_tokens, eos_id=tokenizer.eos_token_id,
                  sparams=sp, generator=torch.Generator(device=device).manual_seed(0),
                  decode_impl=args.decode_impl, decode_params=decode_params, device=device)
        x, n = torch.tensor([ids]), torch.tensor([len(ids)])
        if args.speculative > 0:
            stream = generate_stream_speculative(params, lora, x, n, cfg, lcfg,
                                                 draft_len=args.speculative, **kw)
        else:
            stream = generate_stream(params, lora, x, n, cfg, lcfg, **kw)
        for tok in stream:
            t = int(tok[0])
            if t == tokenizer.eos_token_id:
                break
            reply_ids.append(t)
            # stream decoded delta
            print(tokenizer.decode(reply_ids)[len(tokenizer.decode(reply_ids[:-1])):],
                  end="", flush=True)
        print()
        history[-1] = (user, tokenizer.decode(reply_ids))


if __name__ == "__main__":
    main()
