#!/bin/bash
# Generic finetune recipe (reference scripts/finetune.sh equivalent):
# pythia-12b on alpaca with NF4 + double quant + LoRA on all linears.
python -m qlora_tpu_torch.cli \
    --model_name_or_path EleutherAI/pythia-12b \
    --output_dir ./output \
    --dataset alpaca \
    --do_train true --do_eval true \
    --source_max_len 384 --target_max_len 128 \
    --per_device_train_batch_size 4 \
    --gradient_accumulation_steps 4 \
    --max_steps 10000 \
    --save_steps 1000 \
    --learning_rate 0.0002 \
    --seed 0
