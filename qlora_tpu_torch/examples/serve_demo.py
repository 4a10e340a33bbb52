"""Continuous-batching serving over the paged KV pool, without an HTTP
layer: prompts from a file (one a line) or stdin go through
``PagedBatcher`` (admission, decode and page recycling), and each
completion prints once every request has finished.

  python -m qlora_tpu_torch.examples.serve_demo --model_path /path/to/hf-or-nf4-store \\
      [--adapter_path ./output] [--prompts prompts.txt] \\
      [--num_slots 8] [--max_new_tokens 128] [--tp 4]

``--tp N`` serves a model bigger than one card: N ranks, one process each
(NCCL, rank r on card r; gloo with ``--device cpu``), each running
``PagedBatcher(tp_mesh=...)`` on its shard with head-sharded page pools.
The model and adapter are loaded once, onto the CPU, where every rank's
shard is cut; each rank is handed only its own.  Rank 0's completions are
printed.
"""

from __future__ import annotations

import argparse
import tempfile

import torch

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
                    help="tensor-parallel ranks, one process each (NCCL, a card a rank; "
                         "gloo with --device cpu)")
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--top_p", type=float, default=0.9)
    ap.add_argument("--device", default=None, help="CUDA unless given (cpu: the plain path)")
    return ap.parse_args(argv)


def _engine_kwargs(args, tokenizer) -> dict:
    return dict(num_slots=args.num_slots, n_pages=args.n_pages, decode_impl=args.decode_impl,
                prefill_impl=args.prefill_impl, page_size=args.page_size,
                max_pages_per_seq=args.max_pages_per_seq, eos_id=tokenizer.eos_token_id,
                sparams=SamplingParams(do_sample=True, temperature=args.temperature,
                                       top_p=args.top_p),
                steps_per_dispatch=args.steps_per_dispatch, admit_batch=args.admit_batch)


def _serve(batcher, prompts, max_new_tokens):
    """Submit every prompt (token ids), run to completion; the finished
    requests in submission order."""
    for ids in prompts:
        batcher.submit(ids, max_new_tokens=max_new_tokens)
    return sorted(batcher.run_to_completion(), key=lambda r: r.uid)


def serve_rank(mesh, params, lora, cfg, lcfg, engine, prompts, max_new_tokens):
    """One rank of ``--tp``: its ``PagedBatcher(tp_mesh=mesh)`` over the
    prompts, on this rank's shards of the params and LoRA; (uid, generated
    tokens) of each request."""
    from qlora_tpu_torch.generate.paged import PagedBatcher

    batcher = PagedBatcher(params, lora, cfg, lcfg, tp_mesh=mesh, **engine)
    return [(r.uid, r.generated) for r in _serve(batcher, prompts, max_new_tokens)]


def main(argv=None):
    """Serve the prompts and print each completion; returns the finished
    requests' (uid, generated tokens)."""
    from qlora_tpu_torch.generate.paged import PagedBatcher

    args = parse_args(argv)
    if args.tp > 1:
        cpu = args.device is not None and torch.device(args.device).type == "cpu"
        if not cpu and torch.cuda.device_count() < args.tp:
            raise ValueError(f"--tp {args.tp} needs {args.tp} cards, have "
                             f"{torch.cuda.device_count()}; --device cpu runs the ranks on "
                             "the CPU")
        device = torch.device("cpu")
    else:
        device = resolve_device(args.device)
    params, cfg = load_model(args.model_path, device)
    tokenizer = load_tokenizer(args.model_path)
    lcfg = LoraConfig()
    lora = None
    if args.adapter_path:
        lora, _ = _load.load_adapter(args.adapter_path, cfg, lcfg, device)

    if args.prompts:
        with open(args.prompts) as f:
            prompts = [line.strip() for line in f if line.strip()]
    else:
        print("enter prompts (blank line to start serving):")
        prompts = []
        while (line := input("> ").strip()):
            prompts.append(line)
    ids = [[tokenizer.bos_token_id] + tokenizer.encode(p) for p in prompts]

    engine = _engine_kwargs(args, tokenizer)
    if args.tp > 1:
        from qlora_tpu_torch.parallel import cut_rank_shards, run_ranks

        backend, devices = (("gloo", ["cpu"] * args.tp) if cpu else
                            ("nccl", [f"cuda:{r}" for r in range(args.tp)]))
        shards = cut_rank_shards(params, lora, args.tp)
        del params, lora
        with tempfile.TemporaryDirectory() as store:
            done = run_ranks(serve_rank, args.tp, cfg, lcfg, engine, ids, args.max_new_tokens,
                             per_rank=shards, backend=backend, devices=devices,
                             store_dir=store)[0]
    else:
        batcher = PagedBatcher(params, lora, cfg, lcfg, device=device, **engine)
        done = [(r.uid, r.generated) for r in _serve(batcher, ids, args.max_new_tokens)]
    for uid, generated in done:
        print(f"\n=== {prompts[uid - 1]} ===")
        print(tokenizer.decode(generated))
    return done


if __name__ == "__main__":
    main()
