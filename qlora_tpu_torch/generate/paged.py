"""Paged KV cache pool and continuous batching over it (vLLM-style).

One physical pool of KV pages per layer, ``[n_pages, KVH, page, hd]`` bf16,
shared by all in-flight sequences; each sequence owns a page table mapping
its logical pages to scattered pool pages, so memory follows live tokens,
not slots x max_len.  Decode consumes it through ``forward(cache={"k_pages",
"v_pages", "tables", "length"})``: the paged branch of the model runs
``fused_paged_decode_attention`` for one token and
``fused_paged_chunk_attention`` for a speculative verify chunk, both
appending in place.

The allocator is a host-side free list.  Page 0 is reserved scratch:
inactive slots (table all 0, length 0) still run the decode step and append
there, padded prefill rows scatter there, and evicted sliding-window entries
point there; no sequence owns it, and only inactive slots, whose outputs are
dropped, ever attend it.

``PagedBatcher`` is the JAX engine with its ``jit``/``scan`` programs written
as Python loops over the port's per-layer lists: a prefill is one forward
plus an in-place ``index_copy_`` of its KV into the pages; a decode burst is
``steps_per_dispatch`` forwards and samples with no host read between them;
a speculative burst drafts by n-gram prompt lookup with tensor ops on the
device.  Runs on CUDA unless ``device`` names another device.

``PagedBatcher(tp_mesh=...)`` serves a model over a tensor-parallel world
(``parallel/tp_decode.py``): each rank is a process running the same engine
on the same requests, with its shard of the params and LoRA and pools of
its KVH/tp heads.  Every rank samples from the same gathered logits with
an identically seeded generator; the ranks' tokens are then gathered and
rank 0's used (``TPMesh.same``, which counts any rank that differed), so
that every rank's host state (admissions, preemptions, retirements) stays
the same and the collectives meet.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from qlora_tpu_torch import resolve_device
from qlora_tpu_torch.generate.continuous import Request, engine_device
from qlora_tpu_torch.generate.sampler import SamplingParams, sample_token
from qlora_tpu_torch.lora import LoraConfig
from qlora_tpu_torch.models.config import ModelConfig
from qlora_tpu_torch.models.layers import tp_shard_context
from qlora_tpu_torch.models.transformer import forward, init_cache
from qlora_tpu_torch.ops import default_impl


class PoolExhausted(MemoryError):
    """The shared page pool has no free page (recoverable: the batcher
    preempts the youngest sequence and retries).  Distinct from the plain
    MemoryError raised when one sequence exceeds max_pages_per_seq, which
    preemption cannot fix."""


class PagedPool:
    """Physical page pools (one per layer) and a free-list allocator."""

    def __init__(self, cfg: ModelConfig, n_pages: int, page_size: int = 64,
                 max_pages_per_seq: int = 16, device=None):
        """Pools made on `device`, CUDA unless the caller names one."""
        L, KVH, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        self.device = resolve_device(device)
        self.page_size = page_size
        self.max_pages_per_seq = max_pages_per_seq
        self.n_pages = n_pages
        shape = (n_pages, KVH, page_size, hd)
        self.k_pages = [torch.zeros(shape, dtype=torch.bfloat16, device=self.device)
                        for _ in range(L)]
        self.v_pages = [torch.zeros(shape, dtype=torch.bfloat16, device=self.device)
                        for _ in range(L)]
        self.free: list = list(range(1, n_pages))      # page 0: reserved scratch
        self.tables: dict = {}                         # uid → page ids

    @property
    def n_free(self) -> int:
        return len(self.free)

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def allocate(self, uid: int, n_tokens: int) -> list:
        need = self.pages_needed(n_tokens)
        if need > len(self.free):
            raise PoolExhausted(f"page pool exhausted: need {need}, free {len(self.free)}")
        pages = [self.free.pop() for _ in range(need)]
        self.tables.setdefault(uid, []).extend(pages)
        return pages

    def extend(self, uid: int, new_total_tokens: int) -> None:
        """Grow a sequence's table to cover new_total_tokens."""
        have = len(self.tables.get(uid, ()))
        need = self.pages_needed(new_total_tokens)
        if need > self.max_pages_per_seq:
            raise MemoryError(f"sequence {uid} exceeds max_pages_per_seq")
        for _ in range(need - have):
            if not self.free:
                raise PoolExhausted("page pool exhausted")
            self.tables[uid].append(self.free.pop())

    def release(self, uid: int) -> None:
        self.free.extend(p for p in self.tables.pop(uid, ()) if p != 0)

    def evict_before(self, uid: int, min_pos: int) -> int:
        """Free the pages whose every position is < min_pos (sliding-window
        serving: the kernels never read keys behind the window) and repoint
        their table entries at page 0.  Returns the number of pages freed."""
        pages = self.tables.get(uid)
        if not pages:
            return 0
        freed = 0
        for i in range(min(min_pos // self.page_size, len(pages))):
            if pages[i] != 0:
                self.free.append(pages[i])
                pages[i] = 0
                freed += 1
        return freed

    def table_array(self, uids) -> torch.Tensor:
        """[len(uids), max_pages_per_seq] int32 on the pool's device, padded
        with page 0."""
        out = np.zeros((len(uids), self.max_pages_per_seq), np.int32)
        for i, uid in enumerate(uids):
            pages = self.tables.get(uid, [])
            out[i, :len(pages)] = pages
        return torch.from_numpy(out).to(self.device)

    def scatter(self, layer: int, k: torch.Tensor, v: torch.Tensor, idx) -> None:
        """Write one layer's contiguous KV k, v [R, KVH, T, hd] into the pages
        idx [R, ceil(T / page)] in place (rows' last pages zero-padded)."""
        R, KVH, T, hd = k.shape
        P = self.page_size
        npg = idx.shape[1]
        pad = npg * P - T
        flat = idx.reshape(-1).to(device=self.device, dtype=torch.int64)
        for src, dst in ((k, self.k_pages[layer]), (v, self.v_pages[layer])):
            x = torch.nn.functional.pad(src.to(dst.dtype), (0, 0, 0, pad))
            x = x.reshape(R, KVH, npg, P, hd).permute(0, 2, 1, 3, 4).reshape(R * npg, KVH, P, hd)
            dst.index_copy_(0, flat, x)

    def write_prefill(self, uid: int, k, v) -> None:
        """Scatter a prompt's contiguous KV into uid's pages: k, v [L, KVH,
        T, hd] (stacked, or a per-layer list of [KVH, T, hd])."""
        T = k[0].shape[1]
        self.extend(uid, T)
        idx = torch.as_tensor(self.tables[uid][:self.pages_needed(T)])[None]
        with torch.no_grad():
            for layer in range(len(self.k_pages)):
                self.scatter(layer, k[layer][None], v[layer][None], idx)

    def decode_cache(self, uids, lengths) -> dict:
        """The forward() paged-cache dict for these sequences."""
        return {"k_pages": self.k_pages, "v_pages": self.v_pages,
                "tables": self.table_array(uids),
                "length": torch.as_tensor(np.asarray(lengths), dtype=torch.int32,
                                          device=self.device)}

    def update_from(self, cache: dict) -> None:
        """Take the pools back from a step: the kernels append in place, so
        these are the same tensors and nothing is copied."""
        self.k_pages = list(cache["k_pages"])
        self.v_pages = list(cache["v_pages"])


class PagedBatcher:
    """Continuous batching over the paged pool (the API of
    ``ContinuousBatcher``).

    A fixed slot count; each slot maps to a pool sequence (uid).  Admission
    prefills into a scratch contiguous cache and scatters the prompt's KV
    into pool pages; retirement frees them.  ``admission="optimistic"``
    admits on the prompt's footprint plus a watermark, grows pages on demand
    and preempts the youngest sequence when the pool runs dry (it is
    requeued with prompt + generated tokens and prefilled again);
    ``"reserved"`` admits only while the live requests' worst cases fit.
    ``decode_impl`` "int8" (a per-column int8 serving copy) or "w8a8" (NF4
    nibbles decoded to int8 in the kernel) runs decode steps under
    ``default_impl("w8a8")``; ``prefill_impl="w8a8"`` does the same for
    prefill.  ``spec_draft_len > 0`` turns each decode step into a verify
    chunk of n-gram prompt-lookup drafts plus the pending token, accepted
    greedily (default sampling) or by rejection sampling.

    ``tp_mesh`` (a ``TPMesh``, one engine a rank) serves tensor-parallel:
    the params, LoRA and page pools are this rank's shards (the trees given
    are taken as they are when they carry this rank's shard mark, from
    ``parallel.shard_decode_params`` and ``shard_lora``, else cut here from
    the whole), ``decode_impl="int8"`` decodes on the shard's linears
    requantized per column (the row-parallel ones per K-chunk),
    ``prefill_impl="w8a8"`` runs on each shard, ``steps_per_dispatch`` is 1
    (speculation verifies one [slots, C] chunk a dispatch).
    ``decode_impl="w8a8"`` is single-card only.
    """

    def __init__(self, params, lora, cfg, lcfg=None, *, num_slots=128, n_pages=512,
                 page_size=64, max_pages_per_seq=16, prefill_buckets=(128, 256, 512),
                 eos_id=2, sparams=None, seed=0, decode_impl=None, prefill_impl=None,
                 rolling_eviction=True, tp_mesh=None, steps_per_dispatch=1, admit_batch=1,
                 spec_draft_len=0, spec_ngram=2, spec_adaptive=False, spec_break_even=1.35,
                 admission="optimistic", device=None):
        if decode_impl not in (None, "int8", "w8a8"):
            raise ValueError(f"decode_impl={decode_impl!r}: only 'int8', 'w8a8' or None")
        if prefill_impl not in (None, "w8a8"):
            raise ValueError(f"prefill_impl={prefill_impl!r}: only 'w8a8' or None")
        if admission not in ("optimistic", "reserved"):
            raise ValueError(f"admission={admission!r}")
        if tp_mesh is not None and decode_impl == "w8a8":
            raise NotImplementedError(
                "decode_impl='w8a8' is single-card; tensor-parallel serving takes "
                "decode_impl='int8' (chunk-local per-column int8) or the exact kernels")
        self.tp_mesh = tp_mesh
        self.dev = tp_mesh.device if tp_mesh is not None else engine_device(params, device)
        self.params, self.lora, self.cfg = params, lora, cfg
        self.lcfg = lcfg or LoraConfig()
        self.num_slots = num_slots
        self.eos_id = eos_id
        self.sparams = sparams or SamplingParams()
        self.gen = torch.Generator(device=self.dev).manual_seed(seed)
        self.prefill_buckets = tuple(sorted(prefill_buckets))
        self.decode_impl, self.prefill_impl = decode_impl, prefill_impl
        self.rolling_eviction = rolling_eviction
        self.steps_per_dispatch = max(int(steps_per_dispatch), 1)
        self.admit_batch = max(int(admit_batch), 1)
        # the caches' shapes: this rank's KVH/tp heads under tp
        self._kv_cfg = cfg
        if tp_mesh is not None:
            with torch.no_grad():
                self._shard_for_tp(params, lora)
        elif decode_impl == "int8":
            from qlora_tpu_torch.generate.serve_int8 import requantize_params_int8_unstacked

            with torch.no_grad():
                self.decode_params = requantize_params_int8_unstacked(params)
        else:
            self.decode_params = params
        self.pool = PagedPool(self._kv_cfg, n_pages, page_size, max_pages_per_seq,
                              device=self.dev)
        self.spec_draft_len = int(spec_draft_len)
        self.spec_ngram = int(spec_ngram)
        if self.spec_draft_len > 0:
            sp = self.sparams
            if sp.do_sample and (sp.repetition_penalty != 1.0 or sp.no_repeat_ngram_size > 0):
                raise NotImplementedError(
                    "repetition_penalty / no_repeat_ngram_size do not compose with "
                    "speculation (in-chunk history dependence); drop them or spec_draft_len=0")
            self._ctx_cap = page_size * max_pages_per_seq
            self.ctx_host = np.zeros((num_slots, self._ctx_cap), np.int64)
            self.cur_host = np.zeros((num_slots,), np.int64)
            # acceptance telemetry: spec_tokens / spec_chunks = tokens per chunk
            self.spec_tokens = 0
            self.spec_chunks = 0
            # adaptive gate: below spec_break_even tokens per chunk over a
            # window of chunks, sit out _spec_holdoff dispatches on the plain
            # path, then probe again; the first dispatch is a plain one
            self.spec_adaptive = bool(spec_adaptive)
            self.spec_break_even = float(spec_break_even)
            self._spec_window_chunks = 64
            self._spec_holdoff = 8
            self._spec_tok_acc = 0
            self._spec_chunk_acc = 0
            self._spec_skip = 1 if self.spec_adaptive else 0
            self.spec_plain_dispatches = 0
        self.slot_req = [None] * num_slots
        self.slot_uid = [0] * num_slots          # 0 = free (uid 0 is never used)
        self.last_tokens = np.zeros((num_slots,), np.int64)
        self.lengths = np.zeros((num_slots,), np.int32)
        self.queue = []
        self._uid = 0
        self.admission = admission
        self._watermark = max(1, n_pages // 64)
        self.preemptions = 0
        self.preemption_log = []    # (uid, tokens generated when evicted)
        # (uid, tokens generated when admitted, context length prefilled):
        # the tokens that followed were decoded from the last that many of
        # prompt + generated
        self.admission_log = []
        self._reserved: dict = {}   # reserved mode: uid → its worst-case pages

    def _shard_for_tp(self, params, lora):
        """This rank's shards (cut here unless `params` is this rank's shard
        already, in which case so is `lora`), and under
        ``decode_impl="int8"`` the shard's block linears requantized per
        column (a row-parallel K-chunk per column of its own rows) beside
        the exact shard's dense lm_head."""
        from qlora_tpu_torch.generate.serve_int8 import requantize_linear_int8
        from qlora_tpu_torch.models.layers import QLinear
        from qlora_tpu_torch.parallel.tp_decode import check_tp_shapes, rank_shards

        mesh = self.tp_mesh
        check_tp_shapes(self.cfg, mesh.size)
        self._kv_cfg = dataclasses.replace(self.cfg,
                                           num_kv_heads=self.cfg.num_kv_heads // mesh.size)
        self.params, self.lora = params, lora = rank_shards(params, lora, mesh)
        self.decode_params = params
        if self.decode_impl == "int8":
            blocks = [{name: requantize_linear_int8(v) if isinstance(v, QLinear) else v
                       for name, v in block.items()} for block in params["blocks"]]
            self.decode_params = dict(params, blocks=blocks)
        self.steps_per_dispatch = 1

    def _same(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's `t` on every rank (tokens, acceptance counts), every
        rank's compared (``TPMesh.same``); `t` itself on one card."""
        return t if self.tp_mesh is None else self.tp_mesh.same(t)

    # ------------------------------------------------------------- forwards

    def _ctx(self, impl):
        ctx = contextlib.ExitStack()
        if self.tp_mesh is not None:
            ctx.enter_context(tp_shard_context(self.tp_mesh, style="megatron"))
        if impl:
            ctx.enter_context(default_impl("w8a8"))
        return ctx

    def _decode_forward(self, toks, cache):
        """One decode (or verify-chunk) forward of toks [slots, S]."""
        with self._ctx(self.decode_impl):
            return forward(self.decode_params, self.lora, toks, self.cfg, self.lcfg, cache=cache)

    def _prefill_rows(self, ids, lengths, idx):
        """Prefill ids [R, bucket] (true lengths [R]) through a scratch
        contiguous cache, scatter every layer's KV into the pages idx
        [R, ceil(bucket / page)] and sample each row's first token.  Rows
        past the real ones carry length 1 and pages all 0: their KV lands in
        the scratch page and their token is dropped."""
        R, bucket = ids.shape
        cache = init_cache(self._kv_cfg, R, bucket, device=self.dev)
        positions = torch.arange(bucket, device=self.dev)[None, :].expand(R, bucket)
        with self._ctx(self.prefill_impl):
            logits, cache = forward(self.params, self.lora, ids, self.cfg, self.lcfg,
                                    cache=cache, positions=positions)
        rows = torch.arange(R, device=self.dev)
        toks = self._same(sample_token(logits[rows, lengths.long() - 1], self.sparams, None,
                                       self.gen))
        for layer in range(self.cfg.num_layers):
            self.pool.scatter(layer, cache["k"][layer], cache["v"][layer], idx)
        return toks

    def submit(self, prompt, max_new_tokens=128, on_token=None):
        self._uid += 1
        req = Request(self._uid, list(prompt), max_new_tokens, on_token=on_token)
        self.queue.append(req)
        return req

    @property
    def num_active(self):
        return sum(r is not None for r in self.slot_req)

    # ------------------------------------------------------------ admission

    def _admit(self):
        P = self.pool.page_size
        admits = []   # (slot, req, uid, L, bucket, prompt)
        for slot in range(self.num_slots):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            max_tokens = self.pool.max_pages_per_seq * P
            req = self.queue[0]
            # the prompt must fit the largest bucket and leave room to
            # generate (longer prompts are cut from the left)
            cap = min(max_tokens - req.max_new_tokens, self.prefill_buckets[-1])
            prompt = req.prompt[-cap:]
            L = len(prompt)
            if self.cfg.sliding_window and self.rolling_eviction:
                # rolling eviction keeps about window / page + 2 pages live
                need = max(self.pool.pages_needed(L + 1),
                           self.pool.pages_needed(self.cfg.sliding_window) + 2)
            elif self.admission == "optimistic":
                need = self.pool.pages_needed(L + 1) + self._watermark
            else:
                # the sum of the live requests' worst cases must fit the
                # usable pool, so exhaustion cannot happen mid-decode
                wc = self.pool.pages_needed(L + req.max_new_tokens)
                if sum(self._reserved.values()) + wc > self.pool.n_pages - 1:
                    break
                need = self.pool.pages_needed(L + 1)
            if need > self.pool.n_free:
                break   # not enough pages yet: wait for retirements
            self.queue.pop(0)
            bucket = next((b for b in self.prefill_buckets if b >= L), self.prefill_buckets[-1])
            if self.admission == "reserved":
                self._reserved[req.uid] = wc
            self.pool.allocate(req.uid, L + 1)   # room for the next token too
            self.admission_log.append((req.uid, len(req.generated), L))
            admits.append((slot, req, req.uid, L, bucket, prompt))

        # consecutive same-bucket admissions prefill together in groups of
        # admit_batch rows (a short group pads with dummy rows); a lone
        # admission runs at one row.  Tokens are read once every group is in.
        pending = []
        i = 0
        while i < len(admits):
            bucket = admits[i][4]
            chunk = [admits[i]]
            while (len(chunk) < self.admit_batch and i + len(chunk) < len(admits)
                   and admits[i + len(chunk)][4] == bucket):
                chunk.append(admits[i + len(chunk)])
            i += len(chunk)
            R = 1 if len(chunk) == 1 else self.admit_batch
            npg = -(-bucket // P)
            ids = np.zeros((R, bucket), np.int64)
            lengths = np.ones((R,), np.int64)
            idx = np.zeros((R, npg), np.int64)
            for j, (slot, req, uid, L, _, prompt) in enumerate(chunk):
                ids[j, :L] = prompt
                lengths[j] = L
                pages = self.pool.tables[uid][:npg]
                idx[j, :len(pages)] = pages
            toks = self._prefill_rows(torch.from_numpy(ids).to(self.dev),
                                      torch.from_numpy(lengths).to(self.dev),
                                      torch.from_numpy(idx))
            pending += [(slot, req, uid, L, toks[j]) for j, (slot, req, uid, L, _, _)
                        in enumerate(chunk)]
        for slot, req, uid, L, tok in pending:
            self._finish_admit(slot, req, uid, L, int(tok))

    def _release_slot(self, slot):
        self._reserved.pop(self.slot_uid[slot], None)
        self.pool.release(self.slot_uid[slot])
        self.slot_req[slot] = None
        self.slot_uid[slot] = 0
        self.lengths[slot] = 0
        if self.spec_draft_len > 0:
            self.cur_host[slot] = 0

    def _preempt(self, slot):
        """Evict a live sequence to free its pages: requeue it at the front
        with its verified context as the new prompt, so that re-admission
        prefills prompt + generated and generation continues where it
        stopped."""
        req = self.slot_req[slot]
        req.prompt = list(req.prompt) + list(req.generated)
        self.preemption_log.append((req.uid, len(req.generated)))
        self._release_slot(slot)
        self.queue.insert(0, req)
        self.preemptions += 1

    def _extend_or_preempt(self, slot, target_tokens):
        """Grow `slot`'s table to cover target_tokens; when the pool is dry,
        preempt the youngest other sequence and retry.  Returns False if
        `slot` itself was preempted.  Older sequences always win, so the
        oldest request runs to completion."""
        while self.slot_req[slot] is not None:
            try:
                self.pool.extend(self.slot_uid[slot], target_tokens)
                return True
            except PoolExhausted:
                victims = [s for s, r in enumerate(self.slot_req)
                           if r is not None and s != slot]
                if not victims:
                    # re-admission would grow right back into the same wall
                    raise MemoryError(
                        "page pool too small for a single sequence "
                        f"(need {self.pool.pages_needed(target_tokens)} pages, pool "
                        f"{self.pool.n_pages - 1} usable); raise n_pages or lower "
                        "max_new_tokens") from None
                self._preempt(max(victims, key=lambda s: self.slot_uid[s]))
        return False

    def _finish_admit(self, slot, req, uid, L, tok):
        self._emit(req, tok)
        if req.done:
            self._reserved.pop(uid, None)
            self.pool.release(uid)
            return
        self.slot_req[slot] = req
        self.slot_uid[slot] = uid
        self.last_tokens[slot] = tok
        self.lengths[slot] = L
        if self.spec_draft_len > 0:
            # drafting context: the (cut) prompt, then the pending first token
            self.ctx_host[slot, :] = 0
            if L > 0:
                self.ctx_host[slot, :L] = req.prompt[-L:]
            self.ctx_host[slot, L] = tok
            self.cur_host[slot] = L + 1

    # --------------------------------------------------------------- decode

    def _grow(self, n_tokens):
        """Before a step: roll the window's pages (sliding-window models) and
        grow every active slot's table by n_tokens, preempting on need."""
        window = self.cfg.sliding_window if self.rolling_eviction else None
        for slot, r in enumerate(self.slot_req):
            if r is not None:
                if window:
                    self.pool.evict_before(self.slot_uid[slot],
                                           int(self.lengths[slot]) + 1 - window)
                self._extend_or_preempt(slot, int(self.lengths[slot]) + n_tokens)

    def _room(self):
        cap = self.pool.max_pages_per_seq * self.pool.page_size
        return min((cap - 1 - int(self.lengths[s]) for s, r in enumerate(self.slot_req)
                    if r is not None), default=0)

    def _decode_step(self):
        if self.spec_draft_len > 0 and self._spec_gate():
            r = self._spec_step()
            if r is not None:
                return r
            # a slot is too close to capacity for a full burst: the plain
            # per-token step drains it to retirement

        cap = self.pool.max_pages_per_seq * self.pool.page_size
        # a burst only when every active slot has room for all its tokens
        n = self.steps_per_dispatch
        if n > 1 and self._room() < n:
            n = 1
        self._grow(n)
        if self.num_active == 0:
            return []
        cache = self.pool.decode_cache(self.slot_uid, self.lengths)
        toks = torch.as_tensor(self.last_tokens, device=self.dev)[:, None]
        out = []
        for _ in range(n):
            logits, cache = self._decode_forward(toks, cache)
            tok = self._same(sample_token(logits[:, 0], self.sparams, None, self.gen))
            out.append(tok)
            toks = tok[:, None]
        self.pool.update_from(cache)
        toks_all = torch.stack(out).cpu().numpy()          # [n, slots]: one host read
        for k in range(n):
            for slot, req in enumerate(self.slot_req):
                if req is None:
                    continue
                tok = int(toks_all[k, slot])
                if not req.done:
                    self._emit(req, tok)
                self.last_tokens[slot] = tok
        finished = []
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            # the device advanced every active slot by the whole burst
            if self.spec_draft_len > 0:
                cur = int(self.cur_host[slot])
                self.ctx_host[slot, cur:cur + n] = toks_all[:, slot]
                self.cur_host[slot] += n
            self.lengths[slot] += n
            if req.done or self.lengths[slot] >= cap - 1:
                req.done = True
                finished.append(req)
                self._release_slot(slot)
        return finished

    # ---------------------------------------------------------- speculation

    def _spec_gate(self):
        """Whether this dispatch speculates: always in fixed mode; adaptive
        mode sits out ``_spec_holdoff`` dispatches after tokens per chunk
        fell below ``spec_break_even``, then probes again."""
        if not self.spec_adaptive:
            return True
        if self._spec_skip > 0:
            self._spec_skip -= 1
            self.spec_plain_dispatches += 1
            return False
        return True

    def _spec_account(self, disp_tokens, disp_chunks):
        """Record one speculative dispatch and demote to the plain path when
        the window's tokens per chunk fall below break-even."""
        self.spec_tokens += disp_tokens
        self.spec_chunks += disp_chunks
        if not self.spec_adaptive or not disp_chunks:
            return
        self._spec_tok_acc += disp_tokens
        self._spec_chunk_acc += disp_chunks
        if self._spec_chunk_acc < self._spec_window_chunks:
            return
        if self._spec_tok_acc / self._spec_chunk_acc < self.spec_break_even:
            self._spec_skip = self._spec_holdoff
        self._spec_tok_acc = self._spec_chunk_acc = 0

    def _draft(self, ctx, cur):
        """Per slot, the k tokens that followed the latest earlier occurrence
        of its trailing n-gram (ctx [S, cap] valid through cur [S])."""
        k, n, cap = self.spec_draft_len, self.spec_ngram, self._ctx_cap
        rows = torch.arange(ctx.shape[0], device=ctx.device)
        span = torch.arange(cap - n + 1, device=ctx.device)
        match = torch.ones((ctx.shape[0], cap - n + 1), dtype=torch.bool, device=ctx.device)
        for g in range(n):
            last_g = ctx[rows, (cur - n + g) % cap]
            match &= ctx[:, g:cap - n + 1 + g] == last_g[:, None]
        match &= span[None, :] < (cur - n)[:, None]
        best = torch.where(match, span[None, :], torch.full_like(match, -1, dtype=span.dtype))
        start = (best.amax(1) + n).clamp(0, cap - k)
        return torch.gather(ctx, 1, start[:, None] + torch.arange(k, device=ctx.device)[None])

    def _spec_burst(self, cache, ctx, cur, N):
        """N verify chunks with no host read between them.  ctx [S, cap + 1]
        (the last column a sink for dropped writes), cur [S] = prompt plus
        emitted tokens, the last one pending (its KV not yet written).
        Returns (out [S, N * C] with out[s, :tot[s]] the new tokens, tot [S])."""
        from qlora_tpu_torch.generate.speculative import _target_probs, accept_and_resample

        k = self.spec_draft_len
        C, S, cap = k + 1, self.num_slots, self._ctx_cap
        rows = torch.arange(S, device=self.dev)
        idx = torch.arange(C, device=self.dev)
        out = torch.zeros((S, N * C + 1), dtype=torch.int64, device=self.dev)
        tot = torch.zeros((S,), dtype=torch.int64, device=self.dev)
        for _ in range(N):
            pending = ctx[rows, cur - 1][:, None]
            drafts = self._draft(ctx[:, :cap], cur)
            cache = dict(cache, length=(cur - 1).to(torch.int32))
            logits, cache = self._decode_forward(torch.cat([pending, drafts], 1), cache)
            if self.sparams.do_sample:
                probs = _target_probs(logits.reshape(S * C, -1), self.sparams).reshape(S, C, -1)
                toks, n_acc = accept_and_resample(probs, drafts, self.gen)
                toks, n_acc = self._same(toks.long()), self._same(n_acc.long())
            else:
                toks = self._same(logits.argmax(-1))
                n_acc = 1 + torch.cumprod((drafts == toks[:, :-1]).long(), 1).sum(1)
            keep = idx[None] < n_acc[:, None]
            kept = torch.where(keep, toks, torch.zeros_like(toks))
            out.scatter_(1, torch.where(keep, tot[:, None] + idx[None], N * C), kept)
            ctx.scatter_(1, torch.where(keep, cur[:, None] + idx[None], cap), kept)
            cur = cur + n_acc
            tot = tot + n_acc
        return out[:, :N * C], tot, cache

    def _spec_step(self):
        """One speculative dispatch; returns the finished requests, or None
        when a slot lacks room for a full burst (the caller then takes the
        plain per-token step)."""
        C = self.spec_draft_len + 1
        N = self.steps_per_dispatch
        cap = self.pool.max_pages_per_seq * self.pool.page_size
        # the chunk kernel needs length + C within the table, and slots
        # retire at cap - 1 as on the decode path
        if self._room() < N * C:
            return None
        self._grow(N * C)
        if self.num_active == 0:
            return []
        cache = self.pool.decode_cache(self.slot_uid, self.lengths)
        ctx = torch.zeros((self.num_slots, self._ctx_cap + 1), dtype=torch.int64)
        ctx[:, :self._ctx_cap] = torch.from_numpy(self.ctx_host)
        # inactive slots carry cur 1 (length 0): their chunk lands in page 0
        cur = torch.from_numpy(np.maximum(self.cur_host, 1))
        out, tot, cache = self._spec_burst(cache, ctx.to(self.dev), cur.to(self.dev), N)
        self.pool.update_from(cache)
        out, tot = out.cpu().numpy(), tot.cpu().numpy()
        finished = []
        disp_tokens = disp_chunks = 0
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            t_n = int(tot[slot])
            disp_tokens += t_n
            disp_chunks += N
            for i in range(t_n):
                if not req.done:
                    self._emit(req, int(out[slot, i]))
            # the device advanced the slot by all t_n tokens; the host drops
            # those past eos or the budget, and such slots retire below
            cur = int(self.cur_host[slot])
            self.ctx_host[slot, cur:cur + t_n] = out[slot, :t_n]
            self.cur_host[slot] += t_n
            self.lengths[slot] += t_n
            self.last_tokens[slot] = int(out[slot, t_n - 1])
            if req.done or self.lengths[slot] >= cap - 1:
                req.done = True
                finished.append(req)
                self._release_slot(slot)
        self._spec_account(disp_tokens, disp_chunks)
        return finished

    # ------------------------------------------------------------------ API

    def step(self):
        with torch.no_grad():
            self._admit()
            if self.num_active == 0:
                return []
            return self._decode_step()

    def run_to_completion(self):
        done = []
        while self.queue or self.num_active:
            stepped = self.step()
            done.extend(stepped)
            if not stepped and not self.num_active and self.queue:
                raise MemoryError("queued requests cannot be admitted")
        return done

    def _emit(self, req, tok):
        if tok == self.eos_id:
            req.done = True
            return
        req.generated.append(tok)
        if req.on_token:
            req.on_token(req.uid, tok)
        if len(req.generated) >= req.max_new_tokens:
            req.done = True
