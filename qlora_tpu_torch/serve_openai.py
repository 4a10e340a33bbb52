"""OpenAI-compatible HTTP serving on the port's ``PagedBatcher``.

Many concurrent clients share one card through continuous batching:
admissions interleave with decode, and each client streams its own tokens
as its slot produces them.

API (a subset of OpenAI v1, standard library only):
  POST /v1/completions      {"prompt": str, "max_tokens": int, "stream": bool}
                            → a completion, or SSE chunks ending in
                            ``data: [DONE]``
  POST /v1/chat/completions {"messages": [{"role", "content"}, ...],
                            "max_tokens", "stream"}: the messages flatten to
                            the Guanaco ``### Human:`` / ``### Assistant:``
                            template; generation stops at EOS or at a
                            ``### Human:`` stop string, which is held back
                            from the stream
  GET  /v1/models           → the one served model

Engine model: one background thread owns the ``PagedBatcher`` and loops
``step()``; the HTTP handlers never touch it, they enqueue (prompt, token
queue) pairs and read their queue.  Sampling is an engine-level setting
(``--temperature`` / ``--top_p`` apply to every slot, which the batcher
samples in one dispatch): a request whose sampling parameters differ gets
a 400.  If the engine thread raises, every waiting client's stream ends and
the exception stays on ``ServingEngine.error``.

``ServingEngine`` takes a built model (params, LoRA, config, tokenizer);
``ServingEngine.from_args`` builds one from ``--model_path`` (an HF
checkpoint directory) or ``--debug`` (random ``debug`` weights,
``FakeTokenizer``).  Runs on CUDA unless ``--device`` names another device.

Run:   python -m qlora_tpu_torch.serve_openai --model_path <hf dir> --port 8000
Debug: python -m qlora_tpu_torch.serve_openai --debug --device cpu --port 8000
Try:   curl -N localhost:8000/v1/completions -d \\
         '{"prompt": "Hello", "max_tokens": 16, "stream": true}'
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
import traceback
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from qlora_tpu_torch import resolve_device
from qlora_tpu_torch.generate.sampler import SamplingParams
from qlora_tpu_torch.lora import LoraConfig


class ServingEngine:
    """A background thread driving a ``PagedBatcher``; ``submit`` and
    ``cancel`` are thread-safe."""

    def __init__(self, params, lora, cfg, tokenizer, *, lcfg=None, model_id="debug",
                 slots=32, n_pages=288, page_size=64, max_pages_per_seq=12,
                 prefill_buckets=(128, 256, 512), temperature=0.0, top_p=1.0,
                 decode_impl=None, speculative=0, spec_adaptive=True, steps_per_dispatch=16,
                 admit_batch=4, device=None):
        from qlora_tpu_torch.generate.paged import PagedBatcher

        self.cfg, self.tokenizer, self.model_id = cfg, tokenizer, model_id
        self.sparams = SamplingParams(do_sample=temperature > 0,
                                      temperature=max(temperature, 1e-6), top_p=top_p)
        self.pb = PagedBatcher(
            params, lora, cfg, lcfg, num_slots=slots, n_pages=n_pages, page_size=page_size,
            max_pages_per_seq=max_pages_per_seq, prefill_buckets=prefill_buckets,
            eos_id=tokenizer.eos_token_id, sparams=self.sparams, decode_impl=decode_impl,
            prefill_impl="w8a8" if decode_impl == "int8" else None,
            steps_per_dispatch=steps_per_dispatch, admit_batch=admit_batch,
            spec_draft_len=speculative, spec_adaptive=spec_adaptive, device=device)
        self.error = None                # the exception that ended the engine thread
        self._pending = queue.Queue()    # (prompt_ids, max_tokens, out_q, handle)
        self._cancels = queue.Queue()    # handles to stop early
        self._tracked = {}               # req.uid -> (Request, out_q)
        self._wake = threading.Event()
        self._stop = False
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    @classmethod
    def from_args(cls, args) -> "ServingEngine":
        """The model named by `args` (``--debug`` or ``--model_path``, with
        ``--adapter_path``), built on ``args.device``."""
        device = resolve_device(args.device)
        if args.debug:
            from qlora_tpu_torch.models import get_config, init_params
            from qlora_tpu_torch.utils.testing import FakeTokenizer

            cfg = get_config("debug")
            params = init_params(cfg, seed=0, device=device)
            tokenizer = FakeTokenizer()
            paging = dict(n_pages=64, page_size=8, max_pages_per_seq=8,
                          prefill_buckets=(16, 32))
        else:
            from qlora_tpu_torch.utils.hf_import import load_hf_model
            from qlora_tpu_torch.utils.tokenizer import load_tokenizer

            params, cfg = load_hf_model(args.model_path, quantize_base=True, device=device)
            tokenizer, _ = load_tokenizer(args.model_path)
            paging = dict(n_pages=args.n_pages, page_size=64,
                          max_pages_per_seq=args.max_pages_per_seq,
                          prefill_buckets=(128, 256, 512))
        lora = None
        if args.adapter_path:
            from qlora_tpu_torch.models import init_lora_params
            from qlora_tpu_torch.utils.checkpoint import get_last_checkpoint, load_checkpoint

            ckpt, _ = get_last_checkpoint(args.adapter_path)
            like = init_lora_params(cfg, LoraConfig(), seed=0, device=device)
            lora, _, _ = load_checkpoint(ckpt or args.adapter_path, like)
        return cls(params, lora, cfg, tokenizer,
                   model_id=(args.model_path or "debug").rstrip("/").split("/")[-1],
                   slots=args.slots, temperature=args.temperature, top_p=args.top_p,
                   decode_impl=args.decode_impl, speculative=args.speculative,
                   spec_adaptive=not args.no_spec_adaptive,
                   steps_per_dispatch=args.steps_per_dispatch, admit_batch=args.admit_batch,
                   device=device, **paging)

    def submit(self, prompt_ids, max_tokens):
        """Returns (handle, queue yielding token ids, then None)."""
        out_q = queue.Queue()
        handle = {}
        self._pending.put((prompt_ids, max_tokens, out_q, handle))
        self._wake.set()
        if self.error is not None:     # the engine thread has ended: end this stream too
            out_q.put(None)
        return handle, out_q

    def cancel(self, handle):
        """Early stop (a stop string matched): the engine thread marks the
        request done; its slot retires at the next step."""
        self._cancels.put(handle)
        self._wake.set()

    def shutdown(self):
        self._stop = True
        self._wake.set()
        self.thread.join(timeout=30)

    def _run(self):
        pb = self.pb
        try:
            while not self._stop:
                while True:          # drain submissions into the batcher
                    try:
                        ids, n, out_q, handle = self._pending.get_nowait()
                    except queue.Empty:
                        break
                    req = pb.submit(ids, max_new_tokens=n,
                                    on_token=lambda uid, tok, q=out_q: q.put(tok))
                    handle["req"] = req
                    self._tracked[req.uid] = (req, out_q)
                while True:
                    try:
                        h = self._cancels.get_nowait()
                    except queue.Empty:
                        break
                    if "req" in h:
                        h["req"].done = True     # retires at the next step
                if not (pb.queue or pb.num_active):
                    self._wake.clear()
                    self._wake.wait(timeout=0.2)
                    continue
                pb.step()
                for uid in list(self._tracked):
                    req, out_q = self._tracked[uid]
                    if req.done:
                        del self._tracked[uid]
                        out_q.put(None)          # end of stream
        except Exception as e:  # noqa: BLE001 — end every waiting client's stream
            self.error = e
            traceback.print_exc()
            for uid in list(self._tracked):
                self._tracked.pop(uid)[1].put(None)
            while True:          # requests not yet in the batcher end too
                try:
                    self._pending.get_nowait()[2].put(None)
                except queue.Empty:
                    break


def guanaco_prompt(messages) -> str:
    """The chat messages in the Guanaco template, ending in the assistant's
    turn."""
    parts = []
    for m in messages:
        role, content = m.get("role"), m.get("content", "")
        if role == "system":
            parts.append(content + "\n")
        elif role == "assistant":
            parts.append(f"### Assistant: {content}\n")
        else:
            parts.append(f"### Human: {content}\n")
    return "".join(parts) + "### Assistant:"


STOP = "### Human:"


def make_handler(engine: ServingEngine):
    tok = engine.tokenizer

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/v1/models":
                self._json(200, {"object": "list", "data": [
                    {"id": engine.model_id, "object": "model", "owned_by": "qlora_tpu_torch"}]})
            else:
                self._json(404, {"error": {"message": "not found"}})

        def do_POST(self):
            chat = self.path == "/v1/chat/completions"
            if self.path != "/v1/completions" and not chat:
                self._json(404, {"error": {"message": "not found"}})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
            except Exception:  # noqa: BLE001
                self._json(400, {"error": {"message": "bad JSON"}})
                return
            stop = None
            if chat:
                prompt = guanaco_prompt(body.get("messages", []))
                stop = STOP
            else:
                prompt = body.get("prompt", "")
                if isinstance(prompt, list):
                    prompt = prompt[0] if prompt else ""
            max_tokens = min(int(body.get("max_tokens", 64)), 2048)
            # engine-level sampling: refuse other per-request values rather
            # than ignore them
            for k, have in (("temperature", engine.sparams.temperature),
                            ("top_p", engine.sparams.top_p)):
                want = body.get(k)
                if want is not None and abs(float(want) - have) > 1e-6:
                    self._json(400, {"error": {"message":
                        f"{k} is an engine-level setting on this server "
                        f"(engine {k}={have}); restart with --{k}"}})
                    return
            stream = bool(body.get("stream", False))
            ids = tok.encode(prompt)
            handle, out_q = engine.submit(list(ids), max_tokens)
            cid = ("chatcmpl-" if chat else "cmpl-") + uuid.uuid4().hex[:24]
            created = int(time.time())
            obj = "chat.completion" if chat else "text_completion"

            def payload(delta, fin):
                if chat and stream:
                    c = {"index": 0, "delta": ({"content": delta} if delta else {}),
                         "finish_reason": fin}
                elif chat:
                    c = {"index": 0, "message": {"role": "assistant", "content": delta},
                         "finish_reason": fin}
                else:
                    c = {"index": 0, "text": delta, "finish_reason": fin}
                o = obj + (".chunk" if (chat and stream) else "")
                return {"id": cid, "object": o, "created": created,
                        "model": engine.model_id, "choices": [c]}

            if not stream:
                toks, text, stopped = [], "", False
                while True:
                    t = out_q.get()
                    if t is None:
                        break
                    toks.append(t)
                    if stop:
                        text = tok.decode(toks)
                        hit = text.find(stop)
                        if hit >= 0:
                            text, stopped = text[:hit], True
                            engine.cancel(handle)
                            while out_q.get() is not None:   # drain to the end
                                pass
                            break
                if not stopped:
                    text = tok.decode(toks)
                out = payload(text.rstrip() if chat else text, "stop")
                out["usage"] = {"prompt_tokens": len(ids), "completion_tokens": len(toks),
                                "total_tokens": len(ids) + len(toks)}
                self._json(200, out)
                return

            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(data: bytes):
                self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
                self.wfile.flush()

            def sse(obj_):
                chunk(b"data: " + json.dumps(obj_).encode() + b"\n\n")

            # decode incrementally (state local to this request: the handler
            # lives across keep-alive requests); with a stop string, hold
            # back any tail that could be its prefix
            emitted, sent = [], ""
            while True:
                t = out_q.get()
                if t is None:
                    break
                emitted.append(t)
                text = tok.decode(emitted)
                if stop:
                    hit = text.find(stop)
                    if hit >= 0:
                        final = text[:hit]
                        if len(final) > len(sent):
                            sse(payload(final[len(sent):], None))
                            sent = final
                        engine.cancel(handle)
                        while out_q.get() is not None:
                            pass
                        break
                    safe = len(text)
                    for j in range(max(len(text) - len(stop) + 1, 0), len(text)):
                        if stop.startswith(text[j:]):
                            safe = j
                            break
                    text = text[:safe]
                if len(text) <= len(sent):
                    continue   # a partial multi-byte sequence: wait for more
                sse(payload(text[len(sent):], None))
                sent = text
            sse(payload("", "stop"))
            chunk(b"data: [DONE]\n\n")
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()

    return Handler


def parse_args(argv=None):
    ap = argparse.ArgumentParser("qlora_tpu_torch.serve_openai")
    ap.add_argument("--model_path", default=None)
    ap.add_argument("--adapter_path", default=None)
    ap.add_argument("--debug", action="store_true")
    ap.add_argument("--device", default=None, help="CUDA unless given (cpu: the plain path)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--slots", type=int, default=32)
    ap.add_argument("--n_pages", type=int, default=288)
    ap.add_argument("--max_pages_per_seq", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top_p", type=float, default=1.0)
    ap.add_argument("--decode_impl", default=None, choices=(None, "int8"))
    ap.add_argument("--speculative", type=int, default=0)
    ap.add_argument("--no_spec_adaptive", action="store_true",
                    help="always speculate (skip the acceptance gate)")
    ap.add_argument("--steps_per_dispatch", type=int, default=16)
    ap.add_argument("--admit_batch", type=int, default=4)
    args = ap.parse_args(argv)
    if not args.debug and not args.model_path:
        ap.error("pass --model_path or --debug")
    return args


def main(argv=None):
    args = parse_args(argv)
    engine = ServingEngine.from_args(args)
    srv = ThreadingHTTPServer((args.host, args.port), make_handler(engine))
    print(f"serving {engine.model_id} on http://{args.host}:{args.port} "
          f"({args.slots} slots, spec={args.speculative}, decode_impl={args.decode_impl}, "
          f"device {engine.pb.dev})", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        engine.shutdown()


if __name__ == "__main__":
    main()
