"""4-bit codebooks: NF4 (NormalFloat-4) and FP4, as numpy constants.

The same pinned values as the JAX package's codebooks (QLoRA paper,
arXiv:2305.14314 §3.1): NF4 is the 16 normalised quantile midpoints of
N(0, 1) with an exact zero; FP4 is the E2M1 value set divided by 6, sorted.
"""

from __future__ import annotations

import numpy as np

NF4_CODE = np.array(
    [
        -1.0,
        -0.6961928009986877,
        -0.5250730514526367,
        -0.39491748809814453,
        -0.28444138169288635,
        -0.18477343022823334,
        -0.09105003625154495,
        0.0,
        0.07958029955625534,
        0.16093020141124725,
        0.24611230194568634,
        0.33791524171829224,
        0.4407098352909088,
        0.5626170039176941,
        0.7229568362236023,
        1.0,
    ],
    dtype=np.float32,
)

_FP4_MAGNITUDES = np.array([0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0], dtype=np.float32) / 6.0
FP4_CODE = np.sort(np.concatenate([_FP4_MAGNITUDES, -_FP4_MAGNITUDES])).astype(np.float32)

CODEBOOKS = {"nf4": NF4_CODE, "fp4": FP4_CODE}


def get_code(quant_type: str) -> np.ndarray:
    """The 16-entry float32 codebook for `quant_type`."""
    try:
        return CODEBOOKS[quant_type]
    except KeyError:
        raise ValueError(
            f"unknown quant_type {quant_type!r}; expected one of {sorted(CODEBOOKS)}"
        ) from None
