"""Continuous batching over a slot-based contiguous KV cache.

A fixed pool of batch slots, each holding one in-flight sequence with its
own length; queued requests are admitted into free slots (one prefill each)
while the other slots keep decoding, with no barrier on the longest
sequence.  A host-side scheduler around two steps:

* prefill — run one prompt through the slot's own [1, KVH, bucket, hd]
  view of the cache (written in place), sample its first token;
* decode — one token for every slot through ``fused_decode_attention``.

Runs on CUDA unless ``device`` names another device; ``params`` must live
there.  Sampling draws from a ``torch.Generator`` seeded with ``seed``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from qlora_tpu_torch import resolve_device
from qlora_tpu_torch.generate.sampler import SamplingParams, sample_token
from qlora_tpu_torch.lora import LoraConfig
from qlora_tpu_torch.models.config import ModelConfig
from qlora_tpu_torch.models.transformer import forward, init_cache


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list
    max_new_tokens: int = 128
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    on_token: Optional[Callable[[int, int], None]] = None  # (uid, token)


def engine_device(params, device) -> torch.device:
    """The device a serving engine runs on (CUDA unless named), which must
    be the one `params` live on."""
    device = resolve_device(device)
    if params["embed"].device.type != device.type:
        raise ValueError(f"params live on {params['embed'].device}, not {device}")
    return params["embed"].device


class ContinuousBatcher:
    """Slot-based continuous batching engine (one device)."""

    def __init__(self, params, lora, cfg: ModelConfig, lcfg: LoraConfig = LoraConfig(), *,
                 num_slots: int = 8, max_len: int = 2048,
                 prefill_buckets: tuple = (128, 256, 512, 1024, 2048), eos_id: int = 2,
                 sparams: SamplingParams = SamplingParams(), seed: int = 0, device=None):
        self.dev = engine_device(params, device)
        self.params, self.lora, self.cfg, self.lcfg = params, lora, cfg, lcfg
        self.num_slots, self.max_len = num_slots, max_len
        self.prefill_buckets = tuple(b for b in sorted(prefill_buckets) if b <= max_len) \
            or (max_len,)
        self.eos_id = eos_id
        self.sparams = sparams
        self.gen = torch.Generator(device=self.dev).manual_seed(seed)
        self.cache = init_cache(cfg, num_slots, max_len, device=self.dev)
        self.slot_req: list = [None] * num_slots
        self.last_tokens = np.zeros((num_slots,), np.int64)
        self.queue: list = []
        self._uid = 0

    def submit(self, prompt, max_new_tokens: int = 128, on_token=None) -> Request:
        self._uid += 1
        req = Request(self._uid, list(prompt), max_new_tokens, on_token=on_token)
        self.queue.append(req)
        return req

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self.slot_req)

    def step(self) -> list:
        """Admit queued requests into free slots, then decode one token for
        every active slot.  Returns the requests that finished this step."""
        with torch.no_grad():
            self._admit()
            if self.num_active == 0:
                return []
            return self._decode_step()

    def run_to_completion(self) -> list:
        done = []
        while self.queue or self.num_active:
            done.extend(self.step())
        return done

    def _prefill(self, ids, length: int, slot: int, bucket: int) -> torch.Tensor:
        """The prompt through the slot's [1, KVH, bucket, hd] view of every
        layer's cache (filled in place); returns the logits at its last token."""
        sub = {"k": [x[slot:slot + 1, :, :bucket] for x in self.cache["k"]],
               "v": [x[slot:slot + 1, :, :bucket] for x in self.cache["v"]],
               "length": torch.zeros((1,), dtype=torch.int32, device=self.dev)}
        positions = torch.arange(bucket, device=self.dev)[None, :]
        logits, _ = forward(self.params, self.lora, ids, self.cfg, self.lcfg, cache=sub,
                            positions=positions)
        self.cache["length"][slot] = length
        return logits[0, length - 1]

    def _admit(self):
        for slot in range(self.num_slots):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            prompt = req.prompt[-(self.max_len - req.max_new_tokens):]
            L = len(prompt)
            bucket = next((b for b in self.prefill_buckets if b >= L), self.prefill_buckets[-1])
            ids = torch.zeros((1, bucket), dtype=torch.int64)
            ids[0, :L] = torch.as_tensor(prompt)
            last = self._prefill(ids.to(self.dev), L, slot, bucket)
            tok = int(sample_token(last[None], self.sparams, None, self.gen)[0])
            self._emit(req, tok)
            self.slot_req[slot] = req
            self.last_tokens[slot] = tok
            if req.done:
                self.slot_req[slot] = None

    def _decode_step(self) -> list:
        active = torch.as_tensor([r is not None for r in self.slot_req], device=self.dev)
        toks = torch.as_tensor(self.last_tokens, device=self.dev)[:, None]
        logits, cache = forward(self.params, self.lora, toks, self.cfg, self.lcfg,
                                cache=self.cache)
        tok = sample_token(logits[:, 0], self.sparams, None, self.gen)
        # free slots must not advance: their length stays 0
        self.cache = dict(cache, length=torch.where(active, cache["length"],
                                                    torch.zeros_like(cache["length"])))
        # one device-to-host read for the tokens and one for the lengths
        toks = tok.cpu().numpy()
        lengths = self.cache["length"].cpu().numpy()
        finished = []
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            t = int(toks[slot])
            self._emit(req, t)
            self.last_tokens[slot] = t
            if req.done or int(lengths[slot]) >= self.max_len - 1:
                req.done = True
                finished.append(req)
                self.slot_req[slot] = None
        return finished

    def _emit(self, req: Request, tok: int):
        if tok == self.eos_id:
            req.done = True
            return
        req.generated.append(tok)
        if req.on_token:
            req.on_token(req.uid, tok)
        if len(req.generated) >= req.max_new_tokens:
            req.done = True
