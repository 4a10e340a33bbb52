from .engine import beam_search, decode_loop, generate, generate_stream, prefill
from .sampler import (
    SamplingParams,
    apply_repetition_penalty,
    ban_repeated_ngrams,
    sample_token,
    top_k_mask,
    top_p_mask,
    typical_p_mask,
)
from .search import contrastive_search, group_beam_search
from .speculative import generate_speculative, generate_stream_speculative

__all__ = [
    "decode_loop", "generate", "generate_stream", "prefill", "beam_search",
    "group_beam_search", "contrastive_search", "generate_speculative",
    "generate_stream_speculative", "SamplingParams", "apply_repetition_penalty",
    "ban_repeated_ngrams", "sample_token", "top_k_mask", "top_p_mask", "typical_p_mask",
]


def __getattr__(name):
    # the serving engines load on first use, as in the JAX package
    if name == "ContinuousBatcher":
        from .continuous import ContinuousBatcher
        return ContinuousBatcher
    if name in ("PagedBatcher", "PagedPool"):
        from . import paged
        return getattr(paged, name)
    raise AttributeError(name)
