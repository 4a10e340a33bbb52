"""CLI and train / eval / predict driver: the qlora.py ``train()``
equivalent, on one device, over a mesh of ranks, or over several hosts.

The flags are the JAX package's (``qlora_tpu/cli.py``), name for name and
default for default, plus ``--device`` (CUDA unless given; ``cpu`` runs the
plain PyTorch path).  Unknown flags are an error.  Predict runs
``generate()`` with the search flags (beam, group-beam and contrastive
search and their penalties), or ``generate_speculative`` under
``--predict_speculative``.

``--mesh_dp/--mesh_fsdp/--mesh_tp`` train over dp·fsdp·tp ranks, one
process a rank (``parallel/``).  LoRA: ``--tp_style gather`` (the default)
runs the dp×fsdp×tp step with fsdp weight gathering and ZeRO-1 optimizer
state, ``--tp_style megatron`` the Megatron step over a dp×tp mesh, and
``--mesh_sp`` the sequence-parallel step (ring attention over sp ranks,
composed with the gather style's fsdp and tp; each batch's length padded
to a multiple of sp with ignored labels, as JAX's CLI pads it).
``--full_finetune`` (bits 16) runs the GSPMD step: the dense model and its
AdamW moments sharded over fsdp·tp, the rows over dp
(``parallel/gspmd_step.py``).  The ranks run over NCCL, rank r on
``cuda:r`` (it raises when the machine has fewer cards), or with
``--device cpu`` over gloo on the CPU.  The parent builds the model once,
cuts every rank's shard and hands each rank only its own;
``--per_device_train_batch_size`` is the global batch, as in JAX, which
the data axes divide (dp·fsdp, or dp under GSPMD), and each data rank
takes its rows of the same seeded stream.  Checkpoints are written by
rank 0 in the single-device layout, so that a mesh checkpoint resumes on
one card and a single-card one on a mesh.  What follows training (the
final eval, MMLU, predict) runs in the parent as on one card, with the
trained tree read back from the last checkpoint.

``--coordinator_address host:port --num_processes N --process_id i`` run
one process a host (``parallel/distributed.py: initialize``): each host's
parent builds the model from the same seed or checkpoint, cuts its own
ranks' shards and starts them (ranks p·L .. p·L + L - 1 of the mesh, L the
mesh's ranks over N), and the world meets through process 0's store.  Only
process 0 writes checkpoints, logs, metrics and predictions, and runs what
follows training; the other processes wait for it and return.

Order of work: resume detection, model build, data, the train loop
(logging and save cadence, in-training eval and MMLU), eval, standalone
MMLU, predict (``predictions.jsonl``), ``metrics.json``.

    python -m qlora_tpu_torch.cli --model_name_or_path huggyllama/llama-7b \\
        --init_random --fake_tokenizer --dataset data.jsonl --output_dir out
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
import os
import re
import shutil
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from qlora_tpu_torch import resolve_device

logger = logging.getLogger("qlora_tpu_torch")


@dataclasses.dataclass
class Args:
    # ModelArguments
    model_name_or_path: str = "EleutherAI/pythia-12b"
    trust_remote_code: bool = False
    use_auth_token: bool = False
    # DataArguments
    eval_dataset_size: int = 1024
    max_train_samples: Optional[int] = None
    max_eval_samples: Optional[int] = None
    source_max_len: int = 1024
    target_max_len: int = 256
    dataset: str = "alpaca"
    dataset_format: Optional[str] = None
    # TrainingArguments
    output_dir: str = "./output"
    train_on_source: bool = False
    mmlu_split: str = "eval"
    mmlu_dataset: str = "mmlu-fs"
    do_mmlu_eval: bool = False
    max_mmlu_samples: Optional[int] = None
    mmlu_source_max_len: int = 2048
    full_finetune: bool = False
    adam8bit: bool = False
    double_quant: bool = True
    quant_type: str = "nf4"
    bits: int = 4
    lora_r: int = 64
    lora_alpha: float = 16.0
    lora_dropout: float = 0.0
    max_memory_MB: int = 80000
    report_to: str = "none"
    optim: str = "paged_adamw_32bit"
    per_device_train_batch_size: int = 1
    per_device_eval_batch_size: int = 1
    gradient_accumulation_steps: int = 16
    max_steps: int = 10000
    weight_decay: float = 0.0
    learning_rate: float = 2e-4
    max_grad_norm: float = 0.3
    gradient_checkpointing: bool = True
    # the remat policy when gradient_checkpointing is on: "save_linear" keeps
    # each block linear's base matmul output, "full" only the layer boundaries
    remat_policy: str = "save_linear"
    do_train: bool = True
    do_eval: bool = False
    do_predict: bool = False
    lr_scheduler_type: str = "constant"
    warmup_ratio: float = 0.03
    logging_steps: int = 10
    group_by_length: bool = True
    save_strategy: str = "steps"
    save_steps: int = 250
    save_total_limit: int = 40
    eval_steps: Optional[int] = None
    seed: int = 0
    predict_with_generate: bool = False
    # GenerationArguments
    max_new_tokens: int = 256
    min_new_tokens: Optional[int] = None
    do_sample: bool = False
    num_beams: int = 1
    temperature: float = 1.0
    top_k: int = 50
    top_p: float = 1.0
    typical_p: float = 1.0
    repetition_penalty: float = 1.0
    no_repeat_ngram_size: int = 0
    length_penalty: float = 1.0
    diversity_penalty: float = 0.0
    num_beam_groups: int = 1
    penalty_alpha: Optional[float] = None
    use_cache: bool = True
    # the predict token loop on the int8 serving copy (the prefill stays exact)
    predict_decode_impl: Optional[str] = None
    # prompt-lookup speculative decoding for do_predict: draft length (0 = off)
    predict_speculative: int = 0
    # flags kept for script parity (the trainer always computes in bf16)
    cache_dir: Optional[str] = None
    bf16: bool = True
    fp16: bool = False                         # unsupported: warns, uses bf16
    adam_beta2: float = 0.999
    data_seed: Optional[int] = None            # seed for the train/eval split
    evaluation_strategy: str = "steps"
    logging_strategy: str = "steps"
    dataloader_num_workers: int = 0
    remove_unused_columns: bool = False
    lora_modules: str = "all"                  # every block linear
    use_auth: bool = False
    # extensions of the framework
    mmlu_data_path: Optional[str] = None      # path to a zero/five-shot json
    init_random: bool = False                 # random weights (tests, smoke runs)
    fake_tokenizer: bool = False              # byte tokenizer (tests, smoke runs)
    report_profile: bool = False              # a profiler trace of step start + 5
    mesh_dp: int = 1
    mesh_fsdp: int = 1
    mesh_tp: int = 1
    mesh_sp: int = 1
    # rest the optimizer state in host memory between steps
    optim_host_offload: bool = False
    tp_style: str = "gather"
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    # the port's entry points take a device: CUDA unless given
    device: Optional[str] = None


def _str2bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("true", "1", "yes"):
        return True
    if v.lower() in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"expected bool, got {v!r}")


def parse_args(argv=None) -> Args:
    p = argparse.ArgumentParser("qlora_tpu_torch", allow_abbrev=False)
    for f in dataclasses.fields(Args):
        t = f.type
        opt = f"--{f.name}"
        if t in ("bool", bool):
            p.add_argument(opt, type=_str2bool, nargs="?", const=True, default=f.default)
        elif t in ("Optional[int]", "int", int):
            p.add_argument(opt, type=int, default=f.default)
        elif t in ("float", float):
            p.add_argument(opt, type=float, default=f.default)
        else:
            p.add_argument(opt, type=str, default=f.default)
    ns = p.parse_args(argv)  # unknown flags: an argparse error
    return Args(**vars(ns))


def mesh_shape(args: Args) -> tuple:
    """(dp, fsdp, tp, sp) of the run's mesh."""
    return args.mesh_dp, args.mesh_fsdp, args.mesh_tp, args.mesh_sp


def mesh_style(args: Args) -> str:
    """The mesh step a run takes: "sp" (the sequence-parallel step, which
    shards its weights in the gather style) whenever mesh_sp > 1, "gspmd"
    (the GSPMD step, ``parallel/gspmd_step.py``) for full finetuning, else
    the tp style."""
    if args.mesh_sp > 1:
        return "sp"
    return "gspmd" if args.full_finetune else args.tp_style


def _optimizer_name(args: Args) -> str:
    return "adam8bit" if args.adam8bit else args.optim


def check_supported(args: Args) -> None:
    """Raise for the mesh combinations the JAX CLI refuses (its
    exceptions), and for the one the port adds: full finetuning on a mesh
    with an 8-bit optimizer, whose blockwise state does not follow the
    model's column shards."""
    if args.mesh_sp > 1:
        if args.full_finetune:
            raise NotImplementedError("full_finetune does not compose with mesh_sp")
        if args.mesh_tp > 1 and args.tp_style == "megatron":
            raise ValueError("mesh_sp needs tp_style=gather (head-parallel attention does not "
                             "compose with the ring)")
    if math.prod(mesh_shape(args)) > 1:
        if args.tp_style not in ("gather", "megatron"):
            raise ValueError(f"unknown tp_style {args.tp_style!r}")
        if args.full_finetune and args.tp_style == "megatron":
            raise NotImplementedError("full_finetune shards via GSPMD (tp_style=gather)")
        if args.full_finetune and _optimizer_name(args) in ("adam8bit", "paged_adamw_8bit"):
            raise ValueError("full_finetune on a mesh needs an AdamW-family optimizer (8-bit "
                             "blockwise state does not follow the model's column shards)")
        if mesh_style(args) == "megatron" and args.mesh_fsdp > 1:
            raise ValueError("tp_style=megatron requires mesh_fsdp=1 (compose fsdp via "
                             "tp_style=gather)")
    if (_optimizer_name(args) in ("adam8bit", "paged_adamw_8bit")
            and mesh_style(args) == "megatron" and args.mesh_tp > 1):
        raise ValueError(
            "adam8bit does not compose with tp_style=megatron (8-bit blockwise optimizer "
            "state cannot follow tp-sharded params); use tp_style=gather or a 32-bit optimizer")


def rank_devices(n: int, device) -> tuple:
    """(backend, devices) of the `n` ranks this process starts: NCCL with
    local rank r on ``cuda:r``, or gloo on the CPU when `device` is the
    CPU.  Raises when the machine has fewer cards than ranks."""
    device = torch.device(device)
    if device.type == "cpu":
        return "gloo", ["cpu"] * n
    have = torch.cuda.device_count()
    if have < n:
        raise ValueError(f"a mesh of {n} ranks needs {n} cards (NCCL, a card a rank), have "
                         f"{have}; pass --device cpu to run the ranks on the CPU over gloo")
    return "nccl", [f"cuda:{r}" for r in range(n)]


def build_model_and_tokenizer(args: Args, device):
    """(params, lora or None, cfg, lcfg, tokenizer) on `device`: random
    weights from the seed, a store written by ``save_quantized``, or an HF
    checkpoint directory (on a mesh its intermediate size and vocabulary
    padded to 128 × fsdp·tp: the model computes the same function)."""
    from qlora_tpu_torch.lora import LoraConfig
    from qlora_tpu_torch.models import get_config, init_lora_params, init_params

    lcfg = LoraConfig(r=args.lora_r, alpha=args.lora_alpha, dropout=args.lora_dropout)
    quantize_base = args.bits in (4, 8) and not args.full_finetune
    if args.bits not in (4, 8, 16, 32):
        raise ValueError(f"bits={args.bits} not supported (4, 8, 16, 32)")
    quant_type = "int8" if args.bits == 8 else args.quant_type

    if not args.init_random and os.path.isdir(args.model_name_or_path):
        from qlora_tpu_torch.utils.quantized_store import CONFIG_FILE, load_quantized

        if os.path.exists(os.path.join(args.model_name_or_path, CONFIG_FILE)):
            params, cfg = load_quantized(args.model_name_or_path, device=device)
        else:
            from qlora_tpu_torch.utils.hf_import import load_hf_model

            shards = max(args.mesh_fsdp * args.mesh_tp, 1)
            pad_to = 128 * shards if shards > 1 else None
            params, cfg = load_hf_model(args.model_name_or_path, quantize_base=quantize_base,
                                        quant_type=quant_type, double_quant=args.double_quant,
                                        pad_intermediate_to=pad_to, pad_vocab_to=pad_to,
                                        device=device)
    else:
        cfg = get_config(args.model_name_or_path)
        params = init_params(cfg, seed=args.seed, quantized=quantize_base, device=device,
                             quant_type=quant_type)

    tokenizer = _tokenizer(args)
    lora = None
    if not args.full_finetune:
        lora = init_lora_params(cfg, lcfg, seed=args.seed + 1, device=device)
    return params, lora, cfg, lcfg, tokenizer


def _tokenizer(args: Args):
    if args.fake_tokenizer:
        from qlora_tpu_torch.utils.testing import FakeTokenizer

        return FakeTokenizer()
    from qlora_tpu_torch.utils.tokenizer import load_tokenizer

    return load_tokenizer(args.model_name_or_path)[0]


def _iter_batches(examples, collator, batch_size, accum, seed, group_by_length,
                  tokenizer, max_len, skip_steps=0):
    """Yields stacked [accum, bs, S] numpy batches forever (cycling epochs).

    ``skip_steps``: fast-forward this many optimizer steps without collating
    (a resume picks up at its data position: each epoch's plan is a pure
    function of seed + epoch).  Partial accumulation groups carry across
    epochs.  A group holds its micro-batches' indices and collates them when
    it fills, so a group still partial where the skipping ends completes as
    it would have in the uninterrupted run (the JAX driver keeps a
    placeholder there and fails on it, ROADMAP C10)."""
    from qlora_tpu_torch.train.collator import bucket_batches, example_length

    epoch = 0
    to_skip = skip_steps
    lengths = ([example_length(tokenizer, e) for e in examples]
               if group_by_length else None)
    groups: dict = {}       # bucket length -> pending micro-batches
    while True:
        if group_by_length:
            buckets = [b for b in (64, 128, 256, 512, 1024, 2048, 4096) if b <= max_len]
            buckets = buckets or [max_len]
            if buckets[-1] != max_len:
                buckets.append(max_len)
            plan = bucket_batches(lengths, batch_size, buckets, seed=seed + epoch)
        else:
            rng = np.random.default_rng(seed + epoch)
            order = rng.permutation(len(examples))
            plan = [(order[i: i + batch_size].tolist(), max_len)
                    for i in range(0, len(examples), batch_size)]
        made_progress = False
        for idx, blen in plan:
            if len(idx) < batch_size:
                continue  # keep shapes static
            made_progress = True
            group = groups.setdefault(blen, [])
            group.append(idx)
            if len(group) < accum:
                continue
            groups[blen] = []
            if to_skip > 0:          # a skipped step: nothing collated
                to_skip -= 1
                continue
            collator.pad_to = blen
            micro = [collator([examples[i] for i in g]) for g in group]
            out = {k: np.stack([m[k] for m in micro]) for k in micro[0]}
            if accum == 1:
                out = {k: v[0] for k, v in out.items()}
            yield out
        if not made_progress:
            raise ValueError(
                f"dataset yields no full batch: {len(examples)} examples < "
                f"per_device_train_batch_size={batch_size}")
        epoch += 1


def _numel(tree) -> int:
    from qlora_tpu_torch.train.optimizer import tree_leaves

    return sum(t.numel() for t in tree_leaves(tree))


def _make_optimizer(args: Args):
    from qlora_tpu_torch.train import make_optimizer

    return make_optimizer(
        _optimizer_name(args), args.learning_rate, total_steps=args.max_steps,
        warmup_ratio=args.warmup_ratio, weight_decay=args.weight_decay,
        max_grad_norm=args.max_grad_norm, b2=args.adam_beta2,
        offload_state=args.optim_host_offload)


def _remat(args: Args):
    return args.remat_policy if args.gradient_checkpointing else False


def _datasets(args: Args, do_eval: bool):
    from qlora_tpu_torch.train import make_dataset

    data_seed = args.data_seed if args.data_seed is not None else 42
    return make_dataset(
        args.dataset, dataset_format=args.dataset_format, do_eval=do_eval,
        eval_dataset_size=args.eval_dataset_size, max_train_samples=args.max_train_samples,
        max_eval_samples=args.max_eval_samples, seed=data_seed)


def _collator(args: Args, tokenizer):
    from qlora_tpu_torch.train import CausalCollator

    return CausalCollator(tokenizer, source_max_len=args.source_max_len,
                          target_max_len=args.target_max_len,
                          train_on_source=args.train_on_source)


def _batches(args: Args, train_ds, collator, tokenizer, start_step: int):
    return _iter_batches(
        train_ds, collator, args.per_device_train_batch_size,
        args.gradient_accumulation_steps, args.seed, args.group_by_length, tokenizer,
        args.source_max_len + args.target_max_len, skip_steps=start_step)


def train(args: Args, *, ranks: Optional[tuple] = None, model: Optional[tuple] = None,
          hook=None) -> dict:
    """Train, evaluate and predict as the flags say; returns the metrics
    written to ``metrics.json``.

    ``ranks``: (backend, devices) of a mesh run's ranks, where the caller
    names them (four gloo ranks on one card, say); by default NCCL, a card a
    rank, or gloo on the CPU under ``--device cpu``.  ``model``: (params,
    lora, cfg, lcfg, tokenizer) built by the caller, in place of
    :func:`build_model_and_tokenizer`.  ``hook``: on a mesh, a module-level
    function ``hook(event, ctx)`` that every rank calls at "start", after
    each "step" and at the "end" of its loop, with ``ctx`` holding the
    rank's mesh, state, shard, step and metrics (and the time it entered
    its function, ``entered``); what it puts in
    ``ctx["report"]`` comes back, rank by rank, as the returned dict's
    ``"mesh_report"`` (not written to ``metrics.json``)."""
    from qlora_tpu_torch.train import (
        TrainState, init_train_state, make_eval_step, make_train_step,
    )
    from qlora_tpu_torch.utils.checkpoint import (
        CHECKPOINT_PREFIX, get_last_checkpoint, load_checkpoint, mark_completed, save_checkpoint,
    )
    from qlora_tpu_torch.train.optimizer import tree_map
    from qlora_tpu_torch.utils.metrics import MetricsLogger, StepTimer, maybe_profile

    check_supported(args)
    device = resolve_device(args.device)
    n_ranks = math.prod(mesh_shape(args))
    procs = _join_processes(args, n_ranks)
    if n_ranks > 1:
        ranks = ranks or rank_devices(n_ranks // procs, device)
    os.makedirs(args.output_dir, exist_ok=True)
    all_metrics = {"run_name": args.output_dir}

    ckpt_dir, completed = get_last_checkpoint(args.output_dir)
    if completed:
        logger.info("training already completed; skipping")
        return all_metrics

    params, lora, cfg, lcfg, tokenizer = model or build_model_and_tokenizer(args, device)
    mode = "full" if args.full_finetune else "lora"
    trainable = params if args.full_finetune else lora
    n_train, n_total = _numel(trainable), _numel(params)
    logger.info("trainable params: %d || all params: %d || trainable: %.4f%%",
                n_train, n_total, 100.0 * n_train / max(n_total, 1))

    if args.fp16:
        logger.warning("fp16 unsupported; using bf16 compute")
    optimizer = _make_optimizer(args)
    if n_ranks > 1 and args.do_train:
        # the ranks make their own optimizer state; the parent holds one only
        # to resume it (on the host: a full model's moments need not fit a card)
        cpu_trainable = tree_map(lambda t: t.detach().cpu(), trainable)
        state = TrainState(step=0, trainable=trainable,
                           opt_state=optimizer.init(cpu_trainable) if ckpt_dir else None)
    else:
        state = init_train_state(trainable, optimizer, device=device)
    start_step, resumed_opt = 0, False
    if ckpt_dir is not None:
        loaded, opt_state, info = load_checkpoint(ckpt_dir, state.trainable, state.opt_state)
        start_step = int(info.get("step", 0))
        state = TrainState(step=start_step, trainable=loaded,
                           opt_state=opt_state if opt_state is not None else state.opt_state)
        resumed_opt = opt_state is not None
        logger.info("resumed from %s at step %d", ckpt_dir, start_step)

    collator = _collator(args, tokenizer)
    mlogger = MetricsLogger(args.output_dir, report_to=args.report_to)
    timer = StepTimer()          # no device sync a step: the host reads only at logging steps
    if args.do_train and start_step < args.max_steps and n_ranks > 1:
        if mesh_style(args) == "megatron":
            from qlora_tpu_torch.parallel import requantize_row_parallel

            params = requantize_row_parallel(params, args.mesh_tp)
        out = _train_on_mesh(args, cfg, lcfg, params, state, start_step,
                             state.opt_state if resumed_opt else None, ranks, hook)
        if procs > 1 and out["process"] != 0:
            # process 0 writes every file; the others wait until it is done
            from qlora_tpu_torch.parallel import distributed

            distributed.end_of_run()
            all_metrics["process"] = out["process"]
            if hook is not None:
                all_metrics["mesh_report"] = out["reports"]
            return all_metrics
        all_metrics.update(out["metrics"])
        trained = None
        if args.do_eval or args.do_mmlu_eval or args.do_predict:
            # the trainable tree rank 0 wrote whole at the last step
            trained = load_checkpoint(os.path.join(
                args.output_dir, f"{CHECKPOINT_PREFIX}{args.max_steps}"), state.trainable)[0]
        state = TrainState(step=args.max_steps, trainable=trained, opt_state=None)
        timer.times = out["times"]
    elif args.do_train and start_step < args.max_steps:
        train_ds, eval_ds = _datasets(args, args.do_eval or args.do_predict)
        step_fn = make_train_step(
            cfg, lcfg, optimizer, accum_steps=args.gradient_accumulation_steps, mode=mode,
            remat=_remat(args), device=device)
        eval_fn = (make_eval_step(cfg, lcfg, mode=mode, device=device)
                   if args.do_eval and eval_ds else None)
        batches = _batches(args, train_ds, collator, tokenizer, start_step)
        # restarts from the seed on resume, as the JAX driver's PRNGKey(seed)
        generator = torch.Generator(device=device).manual_seed(args.seed)
        metrics_hist = []
        t0 = time.time()
        for step in range(start_step, args.max_steps):
            profiling = args.report_profile and step == start_step + 5
            with maybe_profile(args.output_dir, profiling):
                timer.tick()
                state, m = step_fn(state, params, next(batches), generator)
                timer.tock()
            t0 = _log_step(args, step, m, t0, metrics_hist, mlogger)
            if args.save_strategy == "steps" and (step + 1) % args.save_steps == 0:
                save_checkpoint(args.output_dir, step + 1, state.trainable, state.opt_state)
                _prune_checkpoints(args.output_dir, args.save_total_limit)
            if args.eval_steps and (step + 1) % args.eval_steps == 0:
                _in_loop_eval(args, step, eval_fn, state, params, collator, eval_ds, mlogger,
                              all_metrics, lambda: _run_mmlu(args, params, state, cfg, lcfg,
                                                             tokenizer, mode, device))
        save_checkpoint(args.output_dir, args.max_steps, state.trainable, state.opt_state)
        mark_completed(args.output_dir)
        all_metrics["train_metrics"] = metrics_hist

    if args.do_eval:
        _, eval_ds = _datasets(args, True)
        ev = make_eval_step(cfg, lcfg, mode=mode, device=device)
        all_metrics["eval_loss"] = _eval_pass(args, ev, state, params, collator, eval_ds)
        logger.info("eval_loss: %.4f", all_metrics["eval_loss"])

    if args.do_mmlu_eval and not args.do_train:
        all_metrics.update(_run_mmlu(args, params, state, cfg, lcfg, tokenizer, mode, device))

    if args.do_predict:
        all_metrics.update(_run_predict(args, params, state, cfg, lcfg, tokenizer, collator,
                                        mode, device))

    if timer.times:
        all_metrics["seconds_per_step_mean"] = timer.mean
    mlogger.close()
    with open(os.path.join(args.output_dir, "metrics.json"), "w") as f:
        json.dump(all_metrics, f, indent=2)
    if n_ranks > 1 and hook is not None and args.do_train and start_step < args.max_steps:
        all_metrics["mesh_report"] = out["reports"]
    if procs > 1:
        from qlora_tpu_torch.parallel import distributed

        distributed.end_of_run()
    return all_metrics


def _join_processes(args: Args, n_ranks: int) -> int:
    """Join the run's processes where the flags name several
    (``--coordinator_address/--num_processes/--process_id``, one process a
    host: its parent and the mesh ranks it starts); their number."""
    if not (args.coordinator_address or (args.num_processes or 0) > 1):
        return 1
    from qlora_tpu_torch.parallel import distributed

    distributed.initialize(args.coordinator_address, args.num_processes, args.process_id)
    procs = distributed.process_count()
    if n_ranks % procs or n_ranks < procs:
        raise ValueError(f"a mesh of {n_ranks} ranks does not split over {procs} processes "
                         "(each starts the same number of ranks)")
    logger.info("distributed: process %d/%d, %d local / %d global ranks",
                distributed.process_index(), procs, n_ranks // procs, n_ranks)
    return procs


def _log_step(args, step, m, t0, metrics_hist, mlogger):
    """The logging cadence: a row of loss, s/step and grad norm every
    ``logging_steps``; returns the clock's new start."""
    if (step + 1) % args.logging_steps:
        return t0
    loss = float(m["loss"])
    dt = (time.time() - t0) / args.logging_steps
    logger.info("step %d: loss %.4f (%.2fs/step)", step + 1, loss, dt)
    row = {"step": step + 1, "loss": loss, "seconds_per_step": dt,
           "grad_norm": float(m["grad_norm"])}
    metrics_hist.append(row)
    if mlogger is not None:
        mlogger.log(row, step=step + 1)
    return time.time()


def _in_loop_eval(args, step, eval_fn, state, params, collator, eval_ds, mlogger, all_metrics,
                  mmlu):
    """The eval cadence's work at step `step`: the eval loss and, with
    ``--do_mmlu_eval``, MMLU (``mmlu()``); logged where `mlogger` is given."""
    if eval_fn is not None:
        ev_loss = _eval_pass(args, eval_fn, state, params, collator, eval_ds)
        logger.info("step %d: eval_loss %.4f", step + 1, ev_loss)
        if mlogger is not None:
            mlogger.log({"eval_loss": ev_loss}, step=step + 1)
    if args.do_mmlu_eval:
        res = mmlu()
        all_metrics.update(res)
        if mlogger is not None:
            mlogger.log({k: v for k, v in res.items()
                         if k in ("mmlu_loss", "mmlu_eval_accuracy")}, step=step + 1)


# ---------------------------------------------------------------------------
# training over a mesh of ranks
# ---------------------------------------------------------------------------


def _train_on_mesh(args, cfg, lcfg, params, state, start_step, opt_state, ranks, hook):
    """Start :func:`mesh_rank` on every rank of this process and, while the
    processes start, cut each of its ranks' shard into a file of its own
    (the gather style's N-shards of `params`, the Megatron shards of a
    re-packed tree, or under GSPMD the rank's slice of the trainable model
    and of the optimizer state a checkpoint held), and the run's job (flags,
    configs, the adapters to start from and the optimizer state a
    checkpoint held, or None: each rank makes its own) into another; a rank
    reads each file once it is whole.  Returns the result of this process's
    first rank, with its process id and every local rank's report."""
    import threading

    from qlora_tpu_torch.parallel import (
        distributed, mesh_coords, run_ranks, shard_params, shard_sharded_params,
    )
    from qlora_tpu_torch.parallel.gspmd_step import cut_state
    from qlora_tpu_torch.parallel.mesh import MeshAxes
    from qlora_tpu_torch.train.optimizer import tree_map

    backend, devices = ranks
    dp, F, T, SP = shape = mesh_shape(args)
    n = dp * F * T * SP
    style = mesh_style(args)
    first = distributed.process_index() * len(devices)
    local = range(first, first + len(devices))
    logger.info("mesh %d x %d x %d x %d (%s style): ranks %d..%d of %d over %s on %s", dp, F, T,
                SP, style, local[0], local[-1], n, backend, ", ".join(map(str, devices)))
    cpu = lambda tree: tree_map(lambda t: t.detach().cpu(), tree)
    # one file a distinct shard: ranks that differ only in dp or sp share it
    if style == "megatron":
        key = lambda r: mesh_coords(r, *shape)[2]
        cut = lambda r: shard_params(params, key(r), T, "cpu")
    elif style == "gspmd":
        key = lambda r: mesh_coords(r, *shape)[1:]
        cut = lambda r: dict(zip(("trainable", "opt_state"), cut_state(
            state.trainable, opt_state, MeshAxes(dp, F, T), *key(r), "full", "cpu")))
    else:
        key = lambda r: mesh_coords(r, *shape)[1:]
        cut = lambda r: shard_sharded_params(params, key(r)[1], key(r)[0], T, F, "cpu")
    whole = style != "gspmd"          # the job carries the whole trainable tree
    with tempfile.TemporaryDirectory() as tmp:
        names = {}
        for r in local:
            names.setdefault(key(r), os.path.join(tmp, f"shard-{len(names)}.pt"))
        job = os.path.join(tmp, "job.pt")
        done: dict = {}

        def ranks_run():
            try:
                done["results"] = run_ranks(
                    mesh_rank, n, job, hook, per_rank=[(names[key(r)],) for r in local],
                    backend=backend, devices=devices, store_dir=tmp, timeout_s=None)
            except BaseException as e:      # re-raised in the parent's thread below
                done["error"] = e

        thread = threading.Thread(target=ranks_run)
        thread.start()
        try:
            with torch.no_grad():
                _write(job, dict(args=args, cfg=cfg, lcfg=lcfg,
                                 trainable=cpu(state.trainable) if whole else None,
                                 opt_state=None if opt_state is None or not whole
                                 else cpu(opt_state),
                                 start_step=start_step))
                written = set()
                for r in local:
                    if key(r) not in written:
                        _write(names[key(r)], cut(r))
                        written.add(key(r))
        except BaseException:
            _write(os.path.join(tmp, "failed"), None)      # the ranks stop waiting
            thread.join()
            raise
        thread.join()
    if "error" in done:
        raise done["error"]
    out = done["results"][0]
    out["reports"] = [r["report"] for r in done["results"]]
    out["process"] = distributed.process_index()
    return out


def _write(path: str, obj) -> None:
    """`obj` saved to `path` whole: written beside it, then renamed."""
    torch.save(obj, path + ".tmp")
    os.replace(path + ".tmp", path)


def _read(path: str):
    """The object :func:`_write` saved at `path`, once it is there (a
    ``failed`` file beside it ends the wait)."""
    failed = os.path.join(os.path.dirname(path), "failed")
    while not os.path.exists(path):
        if os.path.exists(failed):
            raise RuntimeError(f"the parent did not write {path}")
        time.sleep(0.05)
    return torch.load(path, weights_only=False)


def _full_trees(args, state, optimizer, mesh):
    """The trainable tree and the optimizer state whole, in the
    single-device layout (collective: every rank calls it).  Under GSPMD
    the model's shards are gathered a tensor at a time onto rank 0's host,
    and only the model group of rank 0 gathers: the other ranks get
    (None, None)."""
    from qlora_tpu_torch.parallel import gather_megatron_tree, megatron_lora_specs
    from qlora_tpu_torch.parallel.megatron_step import _opt_specs_like
    from qlora_tpu_torch.parallel.sharded_step import full_opt_state

    if mesh_style(args) == "gspmd":
        from qlora_tpu_torch.parallel.gspmd_step import gather_tree, trainable_specs
        from qlora_tpu_torch.parallel.mesh import opt_specs_like

        if mesh.dp.rank != 0:
            return None, None
        keep = mesh.rank == 0
        specs = trainable_specs(state.trainable, "full")
        return (gather_tree(state.trainable, specs, mesh.model, keep=keep),
                gather_tree(state.opt_state,
                            opt_specs_like(state.opt_state, state.trainable, specs),
                            mesh.model, keep=keep))
    if mesh_style(args) == "megatron":
        specs = megatron_lora_specs(state.trainable)
        return (gather_megatron_tree(state.trainable, specs, mesh.tp),
                gather_megatron_tree(state.opt_state, _opt_specs_like(state.opt_state, specs),
                                     mesh.tp))
    return state.trainable, full_opt_state(state, optimizer, mesh)


def mesh_rank(world, shard_path: str, job_path: str, hook=None) -> dict:
    """One rank of a mesh run: its shard (read from `shard_path` once the
    parent has written it, put on its device: the frozen model's, or under
    GSPMD its slice of the trainable model and optimizer state), the
    mesh's groups, the trainable tree and optimizer state as this rank
    holds them, the same seeded data stream as every rank, and the train
    loop with its logging, save and eval cadence; world rank 0 writes the
    log and the checkpoints (the last one holds the trained tree whole).
    Returns the hook's report and the step times, and on rank 0 the
    metrics."""
    from qlora_tpu_torch.parallel import (
        init_megatron_state, init_sharded_train_state, make_global_mesh, make_megatron_train_step,
        make_parallel_mesh, make_sharded_eval_step, make_sharded_train_step, make_sp_train_step,
        tree_to,
    )
    from qlora_tpu_torch.parallel.gspmd_step import (
        make_gspmd_eval_step, make_gspmd_train_step, model_context,
    )
    from qlora_tpu_torch.parallel.mesh import MeshAxes
    from qlora_tpu_torch.train.optimizer import tree_map
    from qlora_tpu_torch.utils.checkpoint import mark_completed, save_checkpoint
    from qlora_tpu_torch.utils.metrics import MetricsLogger, StepTimer, maybe_profile

    entered = time.time()
    # remat's first checkpoint imports torch._dynamo, seconds on a busy host:
    # a rank takes that while the parent is still writing its shard (where
    # the fork server has not: parallel/distributed.py)
    import torch._dynamo  # noqa: F401
    job = _read(job_path)
    args, cfg, lcfg = job["args"], job["cfg"], job["lcfg"]
    style = mesh_style(args)
    if style == "gspmd":
        mesh = make_global_mesh(world, MeshAxes(args.mesh_dp, args.mesh_fsdp, args.mesh_tp),
                                model_axis=True)
    else:
        mesh = make_parallel_mesh(world, *mesh_shape(args))
    dev = mesh.device
    if dev.type == "cpu":
        # a CPU mesh's ranks share the host's cores with whatever else runs there
        torch.set_num_threads(1)
    shard = tree_to(_read(shard_path), dev)
    frozen = None if style == "gspmd" else shard
    tokenizer = _tokenizer(args)
    optimizer = _make_optimizer(args)
    # the model's sharding: the sp step shards its weights in the gather style
    shard_style = "megatron" if style == "megatron" else "gather"
    kw = dict(accum_steps=args.gradient_accumulation_steps, clip_norm=args.max_grad_norm,
              remat=_remat(args))
    if style == "gspmd":
        state = init_sharded_train_state(shard["trainable"], optimizer, mesh,
                                         shard["opt_state"], zero1=False)
        step_fn = make_gspmd_train_step(cfg, lcfg, optimizer, mesh, mode="full", **kw)
    elif style == "megatron":
        state = init_megatron_state(job["trainable"], optimizer, mesh, job["opt_state"])
        step_fn = make_megatron_train_step(cfg, lcfg, optimizer, mesh, **kw)
    else:
        state = init_sharded_train_state(job["trainable"], optimizer, mesh, job["opt_state"])
        make = make_sp_train_step if style == "sp" else make_sharded_train_step
        step_fn = make(cfg, lcfg, optimizer, mesh, **kw)
    start_step = job["start_step"]
    state.step = start_step
    del job
    lead = world.rank == 0
    mlogger = MetricsLogger(args.output_dir, report_to=args.report_to) if lead else None
    collator = _collator(args, tokenizer)
    train_ds, eval_ds = _datasets(args, args.do_eval or args.do_predict)
    if not (args.do_eval and eval_ds):
        eval_fn = None
    elif style == "gspmd":
        eval_fn = make_gspmd_eval_step(cfg, lcfg, mesh, "full")
    else:
        eval_fn = make_sharded_eval_step(cfg, lcfg, mesh, shard_style)
    batches = _batches(args, train_ds, collator, tokenizer, start_step)
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    timer = StepTimer()
    metrics_hist, all_metrics = [], {}
    ctx = dict(mesh=mesh, state=state, frozen=frozen, step=start_step, metrics=None,
               report={}, style=style, entered=entered)
    if hook is not None:
        hook("start", ctx)

    def save(step):
        trained, opt_state = _full_trees(args, state, optimizer, mesh)
        if lead:
            cpu = lambda tree: tree_map(lambda t: t.detach().cpu(), tree)
            save_checkpoint(args.output_dir, step, cpu(trained), cpu(opt_state))
            _prune_checkpoints(args.output_dir, args.save_total_limit)
        del trained, opt_state

    def mmlu():
        from qlora_tpu_torch.models.layers import tp_shard_context

        if style == "gspmd":
            with model_context(mesh):
                return _run_mmlu(args, frozen, state, cfg, lcfg, tokenizer, "full", dev)
        T, F = mesh.shape["tp"], mesh.shape["fsdp"]
        with tp_shard_context(mesh.tp if T > 1 else None, mesh.fsdp if F > 1 else None,
                              shard_style):
            return _run_mmlu(args, frozen, state, cfg, lcfg, tokenizer, "lora", dev)

    t0 = time.time()
    for step in range(start_step, args.max_steps):
        profiling = args.report_profile and step == start_step + 5 and lead
        with maybe_profile(args.output_dir, profiling):
            timer.tick()
            state, m = step_fn(state, frozen, _pad_to(next(batches), args.mesh_sp), generator)
            timer.tock()
        t0 = _log_step(args, step, m, t0, metrics_hist, mlogger)
        if hook is not None:
            ctx.update(state=state, step=step + 1, metrics=m)
            hook("step", ctx)
        if args.save_strategy == "steps" and (step + 1) % args.save_steps == 0:
            save(step + 1)
        if args.eval_steps and (step + 1) % args.eval_steps == 0:
            _in_loop_eval(args, step, eval_fn, state, frozen, collator, eval_ds, mlogger,
                          all_metrics, mmlu)
    save(args.max_steps)
    if lead:
        mark_completed(args.output_dir)
        mlogger.close()
    if hook is not None:
        ctx.update(state=state, step=args.max_steps)
        hook("end", ctx)
    out = dict(report=ctx["report"], times=timer.times)
    if lead:
        all_metrics["train_metrics"] = metrics_hist
        out.update(metrics=all_metrics)
    return out


def _pad_to(batch: dict, multiple: int) -> dict:
    """The batch's sequences padded on the right to a multiple of
    `multiple` (the sp ring's shards): ids 0, labels ``IGNORE_INDEX``, the
    attention mask 0.  Causality keeps the pads out of every real token's
    attention, and the loss ignores them (JAX's CLI pads the same way)."""
    from qlora_tpu_torch.train.loss import IGNORE_INDEX

    pad = -batch["input_ids"].shape[-1] % multiple
    if not pad:
        return batch
    fill = {"labels": IGNORE_INDEX}
    widths = [(0, 0)] * (batch["input_ids"].ndim - 1) + [(0, pad)]
    return {k: np.pad(v, widths, constant_values=fill.get(k, 0)) for k, v in batch.items()}


def _padded_batches(ds, bs):
    """Yield (chunk, n_real) covering every example: the last partial batch
    is padded to bs by repeating its last example (static shapes), and
    n_real marks the genuine rows."""
    for i in range(0, len(ds), bs):
        chunk = list(ds[i: i + bs])
        n_real = len(chunk)
        if n_real < bs:
            chunk = chunk + [chunk[-1]] * (bs - n_real)
        yield chunk, n_real


def _mask_pad_rows(batch: dict, n_real: int) -> dict:
    """Labels -100 on the padded rows: they count no token in the loss."""
    if n_real < batch["labels"].shape[0]:
        batch = dict(batch)
        labels = batch["labels"].copy()
        labels[n_real:] = -100
        batch["labels"] = labels
    return batch


def _eval_pass(args, eval_fn, state, params, collator, eval_ds) -> float:
    bs = max(args.per_device_eval_batch_size, 1)
    tot, n_tot = 0.0, 0
    save_pad = collator.pad_to
    collator.pad_to = args.source_max_len + args.target_max_len
    for chunk, n_real in _padded_batches(eval_ds, bs):
        loss, n = eval_fn(state.trainable, params, _mask_pad_rows(collator(chunk), n_real))
        tot += float(loss) * int(n)
        n_tot += int(n)
    collator.pad_to = save_pad
    return tot / max(n_tot, 1)


# bundled MMLU files that are not the canonical splits (data/mmlu/README.md):
# the five-shot files derive their shots from val records instead of the
# official dev split, and the test files are odd-indexed val stand-ins
_MMLU_DERIVED = {
    "five_shot_mmlu_val.json",
    "zero_shot_mmlu_test.json",
    "five_shot_mmlu_test.json",
}


def _resolve_mmlu_path(args) -> Optional[str]:
    """--mmlu_dataset mmlu-zs|mmlu-fs + --mmlu_split eval|test → data file;
    an explicit --mmlu_data_path wins."""
    if args.mmlu_data_path:
        return args.mmlu_data_path
    tag = "zero_shot" if args.mmlu_dataset == "mmlu-zs" else "five_shot"
    split = "val" if args.mmlu_split in ("eval", "val") else "test"
    fname = f"{tag}_mmlu_{split}.json"
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for cand in (
        os.path.join("data", "mmlu", fname),             # cwd-relative
        os.path.join(repo_root, "data", "mmlu", fname),  # bundled
    ):
        if os.path.exists(cand):
            # scripts/get_mmlu_data.py stamps CANONICAL next to the files it
            # built from the official data; the bundled derived files give
            # numbers that are not comparable to published ones
            stamp = os.path.join(os.path.dirname(cand), "CANONICAL")
            canonical = set()
            if os.path.exists(stamp):
                with open(stamp) as f:
                    canonical = {ln.strip() for ln in f}
            if fname in _MMLU_DERIVED and fname not in canonical:
                logger.warning(
                    "MMLU data %s is a bundled DERIVED split (shots/records "
                    "re-derived from the val file, data/mmlu/README.md): "
                    "accuracies are self-consistent but NOT comparable to "
                    "published MMLU numbers. Build the canonical splits "
                    "OFFLINE from the official data.tar with "
                    "scripts/get_mmlu_data.py --from_tar PATH (or "
                    "--from_hub with network).", cand)
            return cand
    return None


def _prune_checkpoints(output_dir: str, keep: int):
    """save_total_limit: delete the oldest checkpoint dirs beyond `keep`."""
    if not keep or keep <= 0:
        return
    ckpts = []
    for name in os.listdir(output_dir):
        m = re.fullmatch(r"checkpoint-(\d+)", name)
        if m:
            ckpts.append((int(m.group(1)), name))
    for _, name in sorted(ckpts)[:-keep]:
        shutil.rmtree(os.path.join(output_dir, name), ignore_errors=True)


def _run_mmlu(args, params, state, cfg, lcfg, tokenizer, mode, device):
    from qlora_tpu_torch.eval import evaluate_mmlu, load_mmlu_file

    path = _resolve_mmlu_path(args)
    if not path:
        logger.warning("do_mmlu_eval set but no MMLU data found (--mmlu_data_path or "
                       "data/mmlu/, see scripts/get_mmlu_data.py); skipping")
        return {}
    examples = load_mmlu_file(path, args.max_mmlu_samples)
    lora = state.trainable if mode == "lora" else None
    base = params if mode == "lora" else state.trainable
    res = evaluate_mmlu(base, lora, cfg, tokenizer, examples, lcfg=lcfg,
                        batch_size=max(args.per_device_eval_batch_size, 1),
                        source_max_len=args.mmlu_source_max_len, device=device)
    logger.info("MMLU accuracy: %.4f", res.get("mmlu_eval_accuracy", 0.0))
    return res


def _run_predict(args, params, state, cfg, lcfg, tokenizer, collator, mode, device):
    from qlora_tpu_torch.generate import SamplingParams, generate, generate_speculative
    from qlora_tpu_torch.train.data import make_dataset

    _, predict_ds = make_dataset(
        args.dataset, dataset_format=args.dataset_format, do_eval=True,
        eval_dataset_size=args.eval_dataset_size,
        max_eval_samples=args.max_eval_samples, seed=42)
    collator.predict_with_generate = True
    collator.pad_to = args.source_max_len
    sp = SamplingParams(
        do_sample=args.do_sample, temperature=args.temperature, top_k=args.top_k,
        top_p=args.top_p, typical_p=args.typical_p,
        repetition_penalty=args.repetition_penalty,
        no_repeat_ngram_size=args.no_repeat_ngram_size)
    lora = state.trainable if mode == "lora" else None
    base = params if mode == "lora" else state.trainable
    decode_params = None
    if args.predict_decode_impl == "int8":
        # the serving copy, made once for every predict batch
        from qlora_tpu_torch.generate.serve_int8 import requantize_params_int8_unstacked

        with torch.no_grad():
            decode_params = requantize_params_int8_unstacked(base)
    spec_k = int(args.predict_speculative or 0)
    if spec_k > 0 and (args.num_beams > 1 or args.penalty_alpha or args.min_new_tokens):
        raise ValueError("--predict_speculative composes with greedy/sampled decoding only "
                         "(not beams/contrastive/min_new_tokens)")
    bs = max(args.per_device_eval_batch_size, 1)
    out_path = os.path.join(args.output_dir, "predictions.jsonl")
    with open(out_path, "w") as f:
        for chunk, n_real in _padded_batches(predict_ds, bs):
            b = collator(chunk)
            kw = dict(max_new_tokens=args.max_new_tokens, eos_id=tokenizer.eos_token_id,
                      sparams=sp, generator=torch.Generator(device=device).manual_seed(args.seed),
                      decode_impl=args.predict_decode_impl, decode_params=decode_params,
                      device=device)
            if spec_k > 0:
                # prompt-lookup speculation: greedy-exact / rejection-sampled,
                # up to spec_k + 1 tokens a pass over the weights
                toks = generate_speculative(base, lora, b["input_ids"],
                                            b["attention_mask"].sum(-1), cfg, lcfg,
                                            draft_len=spec_k, **kw)
            else:
                toks = generate(
                    base, lora, b["input_ids"], b["attention_mask"].sum(-1), cfg, lcfg,
                    min_new_tokens=args.min_new_tokens or 0, num_beams=args.num_beams,
                    length_penalty=args.length_penalty, num_beam_groups=args.num_beam_groups,
                    diversity_penalty=args.diversity_penalty, penalty_alpha=args.penalty_alpha,
                    **kw)
            for ex, row in zip(chunk[:n_real], toks.cpu().numpy()[:n_real]):
                text = tokenizer.decode([t for t in row.tolist() if t != tokenizer.eos_token_id])
                f.write(json.dumps({**ex, "prediction": text}) + "\n")
    logger.info("wrote %s", out_path)
    return {"predictions_path": out_path}


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    return train(parse_args(argv))


if __name__ == "__main__":
    main()
