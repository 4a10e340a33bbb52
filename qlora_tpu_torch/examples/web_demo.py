"""Streaming web chat: the QLoRA reference's Gradio Colab demo
(examples/guanaco_7B_demo_colab.ipynb) as a web page served by the
standard library, on the port.

* multi-turn history flattened to ``### Human: / ### Assistant:`` turns
  (the notebook's Gradio callback, cell 2);
* the reply streamed to the browser token by token as Server-Sent Events;
* a stop at EOS or at the ``### Human:`` stop string (the notebook's
  StoppingCriteria), never streaming a prefix of it;
* each completed turn optionally POSTed as JSON to a webhook URL (the
  notebook logs conversations the same way).

Requests are serialized through a lock: one card, one decode stream at a
time (``generate/paged.PagedBatcher`` serves many users).  Each reply
samples from a ``torch.Generator`` seeded 0 (the JAX demo's default
``PRNGKey(0)``: the same seed samples other tokens there).

Run:  python -m qlora_tpu_torch.examples.web_demo --model_path <hf dir> [--adapter_path d]
Demo: python -m qlora_tpu_torch.examples.web_demo --debug --device cpu
      (random debug model, byte tokenizer)
"""

from __future__ import annotations

import argparse
import json
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from qlora_tpu_torch import resolve_device
from qlora_tpu_torch.examples import _load
from qlora_tpu_torch.generate import SamplingParams, generate_stream, generate_stream_speculative
from qlora_tpu_torch.lora import LoraConfig

load_model = _load.load_hf
load_tokenizer = _load.load_tokenizer

PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>qlora_tpu chat</title><style>
 body{font-family:system-ui,sans-serif;max-width:44rem;margin:2rem auto;
      padding:0 1rem;background:#fafaf7;color:#1a1a18}
 #log{border:1px solid #ddd;border-radius:8px;background:#fff;
      padding:1rem;min-height:16rem;white-space:pre-wrap}
 .u{color:#355} .b{color:#173} .turn{margin:.5rem 0}
 form{display:flex;gap:.5rem;margin-top:1rem}
 input{flex:1;padding:.5rem;border:1px solid #ccc;border-radius:6px}
 button{padding:.5rem 1rem;border:0;border-radius:6px;background:#246;
        color:#fff;cursor:pointer}
</style></head><body>
<h2>qlora_tpu &mdash; Guanaco chat</h2>
<div id="log"></div>
<form id="f"><input id="m" autocomplete="off" placeholder="Say something…">
<button>Send</button></form>
<script>
const hist = [];   // [user, assistant] turns
const log = document.getElementById('log');
document.getElementById('f').onsubmit = async (e) => {
  e.preventDefault();
  const inp = document.getElementById('m');
  const msg = inp.value.trim();
  if (!msg) return;
  inp.value = '';
  log.insertAdjacentHTML('beforeend',
    `<div class="turn u">you&gt; ${msg.replace(/</g,'&lt;')}</div>`);
  const bot = document.createElement('div');
  bot.className = 'turn b'; bot.textContent = 'bot> ';
  log.appendChild(bot);
  const r = await fetch('/chat', {method:'POST',
    headers:{'Content-Type':'application/json'},
    body: JSON.stringify({history: hist, message: msg})});
  const reader = r.body.getReader();
  const dec = new TextDecoder();
  let reply = '', buf = '';
  for (;;) {
    const {done, value} = await reader.read();
    if (done) break;
    buf += dec.decode(value, {stream:true});
    for (;;) {                      // parse complete SSE events
      const i = buf.indexOf('\\n\\n');
      if (i < 0) break;
      const ev = buf.slice(0, i); buf = buf.slice(i + 2);
      if (ev.startsWith('data: ')) {
        const d = JSON.parse(ev.slice(6));
        if (d.delta !== undefined) { reply += d.delta;
                                     bot.textContent = 'bot> ' + reply; }
      }
    }
    log.scrollTop = log.scrollHeight;
  }
  hist.push([msg, reply]);
};
</script></body></html>"""

STOP = "### Human:"


def build_prompt(history, message):
    """Flatten turns like the demo notebook's Gradio callback (cell 2)."""
    parts = [f"### Human: {u}### Assistant: {a}" for u, a in history]
    parts.append(f"### Human: {message}### Assistant:")
    return "".join(parts)


class ChatEngine:
    """Model, tokenizer and a lock serializing decode streams."""

    def __init__(self, args):
        self.device = device = resolve_device(args.device)
        if args.debug:
            from qlora_tpu_torch.models import get_config, init_params
            from qlora_tpu_torch.utils.testing import FakeTokenizer

            self.cfg = get_config("debug")
            self.params = init_params(self.cfg, seed=0, device=device)
            self.tokenizer = FakeTokenizer()
        else:
            self.params, self.cfg = load_model(args.model_path, device)
            self.tokenizer = load_tokenizer(args.model_path)
        self.lcfg = LoraConfig()
        self.lora = None
        if args.adapter_path:
            self.lora, _ = _load.load_adapter(args.adapter_path, self.cfg, self.lcfg, device)
        self.sparams = SamplingParams(
            do_sample=True, temperature=args.temperature, top_p=args.top_p)
        self.max_new_tokens = args.max_new_tokens
        self.speculative = getattr(args, "speculative", 0)
        self.decode_impl = getattr(args, "decode_impl", None)
        self.decode_params = None
        if self.decode_impl == "int8":
            # the serving copy, built once and reused across turns
            from qlora_tpu_torch.generate.serve_int8 import requantize_params_int8_unstacked

            with torch.no_grad():
                self.decode_params = requantize_params_int8_unstacked(self.params)
        self.lock = threading.Lock()

    def token_stream(self, ids):
        """The token stream of one reply to prompt `ids`."""
        kw = dict(max_new_tokens=self.max_new_tokens, eos_id=self.tokenizer.eos_token_id,
                  sparams=self.sparams,
                  generator=torch.Generator(device=self.device).manual_seed(0),
                  decode_impl=self.decode_impl, decode_params=self.decode_params,
                  device=self.device)
        x, n = torch.tensor([ids]), torch.tensor([len(ids)])
        if self.speculative > 0:
            return generate_stream_speculative(self.params, self.lora, x, n, self.cfg,
                                               self.lcfg, draft_len=self.speculative, **kw)
        return generate_stream(self.params, self.lora, x, n, self.cfg, self.lcfg, **kw)

    def stream_reply(self, history, message):
        """Yield decoded text deltas; stops at EOS or '### Human:'."""
        tok = self.tokenizer
        prompt = build_prompt(history, message)
        ids = [tok.bos_token_id] + tok.encode(prompt)
        reply_ids, sent = [], 0
        with self.lock:
            for step in self.token_stream(ids):
                t = int(step[0])
                if t == tok.eos_token_id:
                    break
                reply_ids.append(t)
                text = tok.decode(reply_ids)
                if STOP in text:                 # notebook StoppingCriteria
                    text = text[: text.index(STOP)]
                    yield text[sent:]
                    return
                # hold back a stop-string prefix at the tail so that no part
                # of "### Human:" reaches the browser (the longest suffix of
                # the text that is a prefix of the stop string)
                safe = len(text)
                for i in range(min(len(STOP), len(text)), 0, -1):
                    if text.endswith(STOP[:i]):
                        safe = len(text) - i
                        break
                if safe > sent:
                    yield text[sent:safe]
                    sent = safe


def make_handler(engine, webhook):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):              # quiet access log
            pass

        def do_GET(self):
            body = PAGE.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            if self.path != "/chat":
                self.send_response(404)
                self.end_headers()
                return
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            history = [tuple(t) for t in req.get("history", [])]
            message = req.get("message", "")
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            reply = []
            for delta in engine.stream_reply(history, message):
                reply.append(delta)
                self.wfile.write(
                    f"data: {json.dumps({'delta': delta})}\n\n".encode())
                self.wfile.flush()
            self.wfile.write(b"data: {\"done\": true}\n\n")
            self.wfile.flush()
            if webhook:                          # notebook conversation log
                record = {"history": list(history),
                          "turn": [message, "".join(reply)]}
                try:
                    urllib.request.urlopen(urllib.request.Request(
                        webhook, json.dumps(record).encode(),
                        {"Content-Type": "application/json"}), timeout=5)
                except Exception:                # logging must never 500 chat
                    pass

    return Handler


def parse_args(argv=None):
    ap = argparse.ArgumentParser("qlora_tpu_torch.examples.web_demo")
    ap.add_argument("--model_path", default=None)
    ap.add_argument("--adapter_path", default=None)
    ap.add_argument("--debug", action="store_true",
                    help="random debug model + byte tokenizer (no weights)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7860)   # gradio's default
    ap.add_argument("--max_new_tokens", type=int, default=512)
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--top_p", type=float, default=0.9)
    ap.add_argument("--log_webhook", default=None,
                    help="POST each completed turn as JSON to this URL")
    ap.add_argument("--decode_impl", default=None, choices=[None, "int8"],
                    help="int8: the token loop through the direct int8 decode kernels "
                         "(the prefill stays exact)")
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="prompt-lookup speculative decoding with K-token drafts (0 = off); "
                         "sampled outputs stay exactly distributed through rejection "
                         "sampling")
    ap.add_argument("--device", default=None, help="CUDA unless given (cpu: the plain path)")
    args = ap.parse_args(argv)
    if not args.debug and not args.model_path:
        ap.error("--model_path required (or --debug)")
    return args


def make_server(args) -> ThreadingHTTPServer:
    """The chat page and its SSE endpoint on (host, port), over a
    ``ChatEngine`` built from `args` (kept as ``srv.engine``); not yet
    serving."""
    engine = ChatEngine(args)
    srv = ThreadingHTTPServer((args.host, args.port), make_handler(engine, args.log_webhook))
    srv.engine = engine
    return srv


def main(argv=None):
    args = parse_args(argv)
    srv = make_server(args)
    print(f"chat ui: http://{args.host}:{srv.server_address[1]}/")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
