#!/bin/bash
# Guanaco 7b recipe — parity with the reference's
# scripts/finetune_guanaco_7b.sh hyperparameters, on the PyTorch port.
# (model path must point to a local HF checkpoint directory)
python -m qlora_tpu_torch.cli \
    --model_name_or_path huggyllama/llama-7b \
    --output_dir ./output/guanaco-7b \
    --logging_steps 10 \
    --save_strategy steps \
    --save_steps 500 \
    --save_total_limit 40 \
    --eval_dataset_size 1024 \
    --max_eval_samples 1000 \
    --per_device_eval_batch_size 1 \
    --max_new_tokens 32 \
    --group_by_length true \
    --do_train true \
    --do_eval true \
    --do_mmlu_eval true \
    --lora_r 64 \
    --lora_alpha 16 \
    --double_quant true \
    --quant_type nf4 \
    --bits 4 \
    --warmup_ratio 0.03 \
    --lr_scheduler_type constant \
    --dataset oasst1 \
    --source_max_len 16 \
    --target_max_len 512 \
    --per_device_train_batch_size 1 \
    --gradient_accumulation_steps 16 \
    --max_steps 1875 \
    --eval_steps 187 \
    --learning_rate 0.0002 \
    --max_grad_norm 0.3 \
    --lora_dropout 0.1 \
    --weight_decay 0.0 \
    --seed 0
