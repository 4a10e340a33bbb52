from .decode_attention import (
    decode_attention_cuda,
    decode_attention_plain,
    fused_decode_attention,
)
from .qmatmul import bf16_matmul, qmatmul, qmatmul_plain, qmm_nf4_fwd_dq, qmm_nf4_fwd_f32

__all__ = [
    "decode_attention_cuda", "decode_attention_plain", "fused_decode_attention",
    "bf16_matmul", "qmatmul", "qmatmul_plain", "qmm_nf4_fwd_dq", "qmm_nf4_fwd_f32",
]
