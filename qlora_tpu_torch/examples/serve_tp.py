"""Tensor-parallel serving demo: greedy decoding of a model sharded over
several cards.

The model is sharded Megatron-style (head-parallel attention, row-parallel
output projections, the KV cache split over its heads; see
``qlora_tpu_torch/parallel/tp_decode.py``) over ``--tp`` ranks, one process
a rank, which this command starts itself: ranks over NCCL, rank r on card r,
or with ``--device cpu`` over gloo on the CPU.  The model is loaded once,
onto the CPU, where every rank's shard is cut; each rank is handed only its
own and moves it onto its device.  The prompt is prefilled and decoded
greedily; each rank takes the argmax of the same gathered logits, rank 0's
token is used (every rank's compared), and the parent prints the text.

  python -m qlora_tpu_torch.examples.serve_tp --model_path /path/to/hf-or-nf4-store \\
      [--tp 4] [--prompt "..."] [--max_new_tokens 64]
  python -m qlora_tpu_torch.examples.serve_tp --debug --device cpu   # random tiny model, tp=2
"""

from __future__ import annotations

import argparse
import tempfile

import torch

from qlora_tpu_torch.examples import _load

load_model = _load.load_store_or_hf
load_tokenizer = _load.load_tokenizer

# the JAX example's debug model: every row-parallel K-chunk packable at tp 2
DEBUG_CONFIG = dict(arch="llama", vocab_size=512, hidden_size=512, intermediate_size=512,
                    num_layers=2, num_heads=4, num_kv_heads=4)


def parse_args(argv=None):
    ap = argparse.ArgumentParser("qlora_tpu_torch.examples.serve_tp")
    ap.add_argument("--model_path")
    ap.add_argument("--tp", type=int, default=0, help="0 = every card (2 on the CPU)")
    ap.add_argument("--prompt", default="The three laws of robotics are")
    ap.add_argument("--max_new_tokens", type=int, default=64)
    ap.add_argument("--debug", action="store_true",
                    help="random tiny model + byte tokenizer (no downloads)")
    ap.add_argument("--device", default=None,
                    help="cuda (default: NCCL, a card a rank) or cpu (gloo)")
    return ap.parse_args(argv)


def serve_rank(mesh, params, cfg, ids, max_new_tokens, eos_id, lora=None, lcfg=None):
    """One rank's part: take its shard of `params` (and of `lora`, a
    per-layer adapter list, where given; either this rank's shards from
    ``parallel.cut_rank_shards`` or the whole trees, cut here) onto the
    rank's device, prefill `ids` into a contiguous cache of the rank's heads
    and decode greedily.  Every rank returns the same tokens (rank 0's,
    every rank's compared each step: ``mesh.disagreements``)."""
    from qlora_tpu_torch.lora import LoraConfig
    from qlora_tpu_torch.models.transformer import init_cache
    from qlora_tpu_torch.parallel.tp_decode import (
        make_tp_forward_fn, rank_shards, shard_tp_cache,
    )

    with torch.no_grad():
        p, lo = rank_shards(params, lora, mesh)
        fn = make_tp_forward_fn(cfg, lcfg or LoraConfig(), mesh)
        cap = len(ids) + max_new_tokens + 1
        cache = shard_tp_cache(init_cache(cfg, 1, cap, device=mesh.device), mesh)
        logits, cache = fn(p, lo, torch.tensor([ids], device=mesh.device), cache)
        tok = mesh.same(logits[0, -1].argmax())
        out = [int(tok)]
        for _ in range(max_new_tokens - 1):
            logits, cache = fn(p, lo, tok.reshape(1, 1), cache)
            tok = mesh.same(logits[0, 0].argmax())
            if int(tok) == eos_id:
                break
            out.append(int(tok))
    return out


def main(argv=None):
    from qlora_tpu_torch.parallel import cut_rank_shards, run_ranks

    args = parse_args(argv)
    cpu = args.device is not None and torch.device(args.device).type == "cpu"
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device present; pass --device cpu to run the ranks on "
                           "the CPU over gloo")
    tp = args.tp or (2 if cpu else torch.cuda.device_count())
    if args.debug:
        from qlora_tpu_torch.models.config import ModelConfig
        from qlora_tpu_torch.models.transformer import init_params
        from qlora_tpu_torch.utils.testing import FakeTokenizer

        cfg = ModelConfig(**DEBUG_CONFIG)
        params = init_params(cfg, seed=0, device="cpu")
        tok = FakeTokenizer()
        tp = min(tp, 2)
    else:
        params, cfg = load_model(args.model_path, "cpu")
        tok = load_tokenizer(args.model_path)
    if cpu:
        backend, devices = "gloo", ["cpu"] * tp
    else:
        if torch.cuda.device_count() < tp:
            raise ValueError(f"--tp {tp} needs {tp} cards, have {torch.cuda.device_count()}")
        backend, devices = "nccl", [f"cuda:{r}" for r in range(tp)]
    print(f"tp={tp} over {backend} ({', '.join(devices)}); sharding params ...")
    ids = [tok.bos_token_id] + tok.encode(args.prompt)
    eos = getattr(tok, "eos_token_id", -1)
    shards = [(p,) for p, _ in cut_rank_shards(params, None, tp)]
    del params
    with tempfile.TemporaryDirectory() as store:
        out = run_ranks(serve_rank, tp, cfg, ids, args.max_new_tokens, eos, per_rank=shards,
                        backend=backend, devices=devices, store_dir=store)[0]
    print(args.prompt + tok.decode(out))
    return out


if __name__ == "__main__":
    main()
