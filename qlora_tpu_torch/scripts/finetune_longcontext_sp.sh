#!/bin/bash
# Long-context finetune through ring-attention sequence parallelism, on the
# PyTorch port (the JAX package's scripts/finetune_longcontext_sp.sh,
# hyperparameters for hyperparameters).  The reference's only sequence
# levers were gradient checkpointing and 4-bit weights.
#
# The sequence dim shards over --mesh_sp ranks: a rank's activation memory
# scales as S/sp, so four ranks train four times one card's context.  The
# key and value shards rotate rank to rank (ops/ring_attention.py: each
# chunk on the flash kernels, exact gradients); the weights stay whole on
# every rank (the LoRA state is small).  Compose more throughput with
# --mesh_dp; each batch's length is padded to a multiple of sp.  The ranks
# run over NCCL, a card a rank (four cards here).
# (model path must point to a local HF checkpoint directory)
python -m qlora_tpu_torch.cli \
    --model_name_or_path huggyllama/llama-7b \
    --output_dir ./output/guanaco-7b-longctx \
    --logging_steps 10 \
    --save_strategy steps \
    --save_steps 250 \
    --save_total_limit 40 \
    --group_by_length true \
    --do_train true \
    --lora_r 64 \
    --lora_alpha 16 \
    --double_quant true \
    --quant_type nf4 \
    --bits 4 \
    --warmup_ratio 0.03 \
    --lr_scheduler_type constant \
    --dataset oasst1 \
    --source_max_len 2048 \
    --target_max_len 6144 \
    --per_device_train_batch_size 1 \
    --gradient_accumulation_steps 16 \
    --max_steps 1875 \
    --learning_rate 0.0002 \
    --adam_beta2 0.999 \
    --max_grad_norm 0.3 \
    --lora_dropout 0.1 \
    --weight_decay 0.0 \
    --seed 0 \
    --mesh_sp 4
