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
    default_impl,
    int8_matmul_plain,
    qmatmul,
    qmatmul_bwd_plain,
    qmatmul_plain,
    qmm_i8_bwd,
    qmm_i8_bwd_plain,
    qmm_i8_direct,
    qmm_i8_direct_plain,
    qmm_i8_fwd,
    qmm_i8_fwd_plain,
    qmm_nf4_bwd,
    qmm_nf4_fwd_dq,
    qmm_nf4_fwd_f32,
    qmm_nf4_w8a8,
    qmm_nf4_w8a8_plain,
    quantize_rows,
    set_default_impl,
    w8a8_codes,
    w8a8_scales,
)

__all__ = [
    "decode_attention_cuda", "decode_attention_plain", "fused_decode_attention",
    "attention_reference", "flash_attention", "flash_attention_lse", "flash_bwd_dkv",
    "flash_bwd_dq", "flash_bwd_plain", "flash_fwd", "flash_fwd_plain",
    "bf16_matmul", "default_impl", "int8_matmul_plain", "qmatmul", "qmatmul_bwd_plain",
    "qmatmul_plain", "qmm_i8_bwd", "qmm_i8_bwd_plain", "qmm_i8_direct", "qmm_i8_direct_plain",
    "qmm_i8_fwd", "qmm_i8_fwd_plain", "qmm_nf4_bwd", "qmm_nf4_fwd_dq", "qmm_nf4_fwd_f32",
    "qmm_nf4_w8a8", "qmm_nf4_w8a8_plain", "quantize_rows", "set_default_impl", "w8a8_codes",
    "w8a8_scales",
]
