"""The examples' load helpers: the base model, the tokenizer and a trained
adapter, each on the device the example runs on."""

from __future__ import annotations

import os


def load_hf(path: str, device):
    """(params, cfg): an HF checkpoint directory, the base NF4-quantized."""
    from qlora_tpu_torch.utils.hf_import import load_hf_model

    return load_hf_model(path, quantize_base=True, device=device)


def load_store_or_hf(path: str, device):
    """(params, cfg): a store written by ``save_quantized`` where its config
    file is there, else an HF checkpoint directory quantized on load."""
    from qlora_tpu_torch.utils.quantized_store import CONFIG_FILE, load_quantized

    if os.path.exists(os.path.join(path, CONFIG_FILE)):
        return load_quantized(path, device=device)
    return load_hf(path, device)


def load_tokenizer(path: str):
    from qlora_tpu_torch.utils.tokenizer import load_tokenizer as load

    return load(path)[0]


def load_adapter(adapter_path: str, cfg, lcfg, device):
    """(lora, checkpoint dir): the latest ``checkpoint-N`` under
    `adapter_path`, or `adapter_path` itself when it holds none."""
    from qlora_tpu_torch.models import init_lora_params
    from qlora_tpu_torch.utils.checkpoint import get_last_checkpoint, load_checkpoint

    ckpt, _ = get_last_checkpoint(adapter_path)
    ckpt = ckpt or adapter_path
    like = init_lora_params(cfg, lcfg, seed=0, device=device)
    lora, _, _ = load_checkpoint(ckpt, like)
    return lora, ckpt
