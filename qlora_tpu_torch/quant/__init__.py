from .blockwise import (
    ABSMAX_BLOCK,
    DEFAULT_BLOCK,
    QuantizedTensor,
    absmax_f32,
    dequantize,
    dequantize_absmax,
    double_quantize_absmax,
    local_chunk,
    logical_k,
    quantize,
    quantize_k_sharded,
    unpack_indices,
)
from .codebooks import CODEBOOKS, FP4_CODE, NF4_CODE, get_code

__all__ = [
    "ABSMAX_BLOCK", "DEFAULT_BLOCK", "QuantizedTensor", "absmax_f32",
    "dequantize", "dequantize_absmax", "double_quantize_absmax",
    "local_chunk", "logical_k", "quantize", "quantize_k_sharded",
    "unpack_indices", "CODEBOOKS", "FP4_CODE", "NF4_CODE", "get_code",
]
