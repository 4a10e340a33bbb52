#!/bin/bash
# Inference-only run (reference scripts/generate.sh equivalent):
# --do_predict with sampled generation, writes predictions.jsonl.
python -m qlora_tpu_torch.cli \
    --model_name_or_path EleutherAI/pythia-12b \
    --output_dir ./output \
    --dataset alpaca \
    --do_train false --do_predict true \
    --predict_with_generate true \
    --max_new_tokens 128 --do_sample true --top_p 0.9 --temperature 0.7
