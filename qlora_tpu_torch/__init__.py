"""qlora_tpu_torch — the PyTorch + CUDA (Hopper) port of ``qlora_tpu``.

Storage layouts match the JAX package byte for byte (split-half NF4/FP4
nibbles, column-aligned double-quantized absmax, [B, KVH, T, hd] KV cache),
so tensors carry across unchanged.  Every op on the serving path has a plain
PyTorch version, taken only for CPU tensors, and a hand-written CUDA kernel
(``csrc/``), taken for CUDA tensors.
"""

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    Raises when no CUDA device is present and none was asked for — the port
    never carries on quietly on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device present; pass device='cpu' to run the plain "
                "PyTorch path explicitly")
        return torch.device("cuda")
    return torch.device(device)
