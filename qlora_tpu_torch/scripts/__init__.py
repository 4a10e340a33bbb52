"""The port's command-line scripts (``python -m qlora_tpu_torch.scripts.<name>``)
and the QLoRA paper's training and predict recipes as shell scripts, each
calling ``python -m qlora_tpu_torch.cli``."""
