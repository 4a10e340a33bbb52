from .decode_attention import (
    decode_attention_cuda,
    decode_attention_plain,
    fused_decode_attention,
)
from .flash_attention import (
    attention_reference,
    flash_attention,
    flash_attention_lse,
    flash_bwd_dkv,
    flash_bwd_dq,
    flash_bwd_plain,
    flash_fwd,
    flash_fwd_plain,
)
from .qmatmul import (
    bf16_matmul,
    qmatmul,
    qmatmul_bwd_plain,
    qmatmul_plain,
    qmm_nf4_bwd,
    qmm_nf4_fwd_dq,
    qmm_nf4_fwd_f32,
)

__all__ = [
    "decode_attention_cuda", "decode_attention_plain", "fused_decode_attention",
    "attention_reference", "flash_attention", "flash_attention_lse", "flash_bwd_dkv",
    "flash_bwd_dq", "flash_bwd_plain", "flash_fwd", "flash_fwd_plain",
    "bf16_matmul", "qmatmul", "qmatmul_bwd_plain", "qmatmul_plain", "qmm_nf4_bwd",
    "qmm_nf4_fwd_dq", "qmm_nf4_fwd_f32",
]
