"""Continuous-batching serving over the paged KV pool, without an HTTP
layer: prompts from a file (one a line) or stdin go through
``PagedBatcher`` (admission, decode and page recycling), and each
completion prints once every request has finished.

  python -m qlora_tpu_torch.examples.serve_demo --model_path /path/to/hf-or-nf4-store \\
      [--adapter_path ./output] [--prompts prompts.txt] \\
      [--num_slots 8] [--max_new_tokens 128]
"""

from __future__ import annotations

import argparse

from qlora_tpu_torch import resolve_device
from qlora_tpu_torch.examples import _load
from qlora_tpu_torch.generate.sampler import SamplingParams
from qlora_tpu_torch.lora import LoraConfig

load_model = _load.load_store_or_hf
load_tokenizer = _load.load_tokenizer


def parse_args(argv=None):
    ap = argparse.ArgumentParser("qlora_tpu_torch.examples.serve_demo")
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--adapter_path", default=None)
    ap.add_argument("--prompts", default=None, help="file of prompts (one/line)")
    ap.add_argument("--num_slots", type=int, default=128)
    ap.add_argument("--decode_impl", default=None, choices=[None, "int8", "w8a8"],
                    help="int8: a per-column int8 serving copy and the direct int8 decode "
                         "kernels; w8a8: the NF4 weights decoded to int8 codes in the "
                         "kernel; default exact")
    ap.add_argument("--prefill_impl", default=None, choices=[None, "w8a8"],
                    help="w8a8: the prefill on the int8 tensor-core kernel over NF4; "
                         "default exact")
    ap.add_argument("--n_pages", type=int, default=2048)
    ap.add_argument("--page_size", type=int, default=16)
    ap.add_argument("--max_pages_per_seq", type=int, default=64,
                    help="per-sequence token cap = max_pages_per_seq x "
                         "page_size (default 64 x 16 = 1024 tokens; "
                         "PagedBatcher's own default of 16 pages assumes "
                         "the bigger 64-token pages)")
    ap.add_argument("--max_new_tokens", type=int, default=128)
    ap.add_argument("--steps_per_dispatch", type=int, default=1,
                    help="decode tokens generated a dispatch (admissions and EOS "
                         "retire at burst boundaries)")
    ap.add_argument("--admit_batch", type=int, default=1,
                    help="admissions prefilled together (same-bucket prompts group "
                         "into one [admit_batch, bucket] prefill; short groups pad "
                         "with dummy rows)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel cards (> 1 is not ported: ROADMAP A7)")
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--top_p", type=float, default=0.9)
    ap.add_argument("--device", default=None, help="CUDA unless given (cpu: the plain path)")
    return ap.parse_args(argv)


def main(argv=None):
    from qlora_tpu_torch.generate.paged import PagedBatcher

    args = parse_args(argv)
    if args.tp > 1:
        raise NotImplementedError(
            f"tensor-parallel serving (--tp {args.tp}) is not ported: ROADMAP A7, parallelism")
    device = resolve_device(args.device)
    params, cfg = load_model(args.model_path, device)
    tokenizer = load_tokenizer(args.model_path)
    lcfg = LoraConfig()
    lora = None
    if args.adapter_path:
        lora, _ = _load.load_adapter(args.adapter_path, cfg, lcfg, device)

    batcher = PagedBatcher(
        params, lora, cfg, lcfg,
        num_slots=args.num_slots, n_pages=args.n_pages, decode_impl=args.decode_impl,
        prefill_impl=args.prefill_impl, page_size=args.page_size,
        max_pages_per_seq=args.max_pages_per_seq,
        eos_id=tokenizer.eos_token_id,
        sparams=SamplingParams(do_sample=True, temperature=args.temperature,
                               top_p=args.top_p),
        steps_per_dispatch=args.steps_per_dispatch,
        admit_batch=args.admit_batch,
        device=device,
    )

    if args.prompts:
        with open(args.prompts) as f:
            prompts = [line.strip() for line in f if line.strip()]
    else:
        print("enter prompts (blank line to start serving):")
        prompts = []
        while (line := input("> ").strip()):
            prompts.append(line)

    reqs = {}
    for p in prompts:
        ids = [tokenizer.bos_token_id] + tokenizer.encode(p)
        r = batcher.submit(ids, max_new_tokens=args.max_new_tokens)
        reqs[r.uid] = p

    done = batcher.run_to_completion()
    for r in sorted(done, key=lambda r: r.uid):
        print(f"\n=== {reqs.get(r.uid, r.uid)} ===")
        print(tokenizer.decode(r.generated))


if __name__ == "__main__":
    main()
