"""The port's examples (``qlora_tpu_torch/examples``) on the CPU ``debug``
model, each through its ``main(argv)`` with only its load helpers replaced,
against the port's own direct calls on the same weights, adapter and
sampling seed (the JAX examples sample with ``PRNGKey``, the port with
``torch.Generator``, so sampled tokens are held to the port, not to JAX).
The pieces without an RNG (the prompt template, both ``build_prompt``s) are
held to the JAX examples, loaded by path; the four cases of
``tests/test_web_demo.py`` are mirrored on the port's ``web_demo --debug``.

``ShownTokenizer`` renders every id, so equal printed text means equal
tokens."""

import importlib.util
import io
import json
import sys
import threading
import urllib.request
from argparse import Namespace
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest
import torch

from qlora_tpu_torch.examples import chat_demo, guanaco_generate, serve_demo, web_demo
from qlora_tpu_torch.generate import (
    SamplingParams, generate, generate_stream, generate_stream_speculative,
)
from qlora_tpu_torch.generate.paged import PagedBatcher
from qlora_tpu_torch.lora import LoraConfig
from qlora_tpu_torch.models import forward, get_config, init_lora_params, init_params
from qlora_tpu_torch.utils.checkpoint import save_checkpoint
from qlora_tpu_torch.utils.testing import FakeTokenizer, ShownTokenizer

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
SAMPLE = SamplingParams(do_sample=True, temperature=0.7, top_p=0.9)


def jax_example(name):
    """A JAX example module, loaded by path (it imports jax and qlora_tpu)."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """The debug model, a LoRA with nonzero B saved as checkpoint-3 of an
    adapter directory, and the same LoRA in memory."""
    cfg = get_config("debug")
    params = init_params(cfg, seed=0, device="cpu")
    lcfg = LoraConfig()
    lora = init_lora_params(cfg, lcfg, seed=1, device="cpu")
    g = torch.Generator().manual_seed(2)
    for layer in lora:
        for ad in layer.values():
            ad["b"].normal_(0.0, 0.05, generator=g)
    adapter = tmp_path_factory.mktemp("adapter")
    save_checkpoint(str(adapter), 3, lora)
    return Namespace(cfg=cfg, params=params, lcfg=lcfg, lora=lora, adapter=str(adapter),
                     ckpt=str(adapter / "checkpoint-3"), tok=ShownTokenizer())


@pytest.fixture
def loaded(model, monkeypatch):
    """Every example's load helpers hand out the debug model and ShownTokenizer."""
    for mod in (guanaco_generate, chat_demo, serve_demo, web_demo):
        monkeypatch.setattr(mod, "load_model", lambda path, device: (model.params, model.cfg))
        monkeypatch.setattr(mod, "load_tokenizer", lambda path: model.tok)
    return model


def streamed(tok, stream):
    """What chat_demo prints for a token stream, and the reply's text."""
    printed, reply = "", []
    for step in stream:
        t = int(step[0])
        if t == tok.eos_token_id:
            break
        reply.append(t)
        printed += tok.decode(reply)[len(tok.decode(reply[:-1])):]
    return printed, tok.decode(reply)


@pytest.mark.parametrize("decode_impl", [None, "int8"])
def test_guanaco_generate_prints_the_direct_generate(loaded, capsys, decode_impl):
    m = loaded
    argv = ["--model_path", "hf", "--adapter_path", m.adapter, "--prompt", "Name a colour.",
            "--max_new_tokens", "12", "--seed", "5", "--device", "cpu"]
    guanaco_generate.main(argv + (["--decode_impl", decode_impl] if decode_impl else []))
    ids = [m.tok.bos_token_id] + m.tok.encode("### Human: Name a colour.### Assistant:")
    toks = generate(m.params, m.lora, torch.tensor([ids]), torch.tensor([len(ids)]), m.cfg,
                    m.lcfg, max_new_tokens=12, eos_id=m.tok.eos_token_id, sparams=SAMPLE,
                    generator=torch.Generator().manual_seed(5), decode_impl=decode_impl,
                    device="cpu")
    text = m.tok.decode([t for t in toks[0].tolist() if t != m.tok.eos_token_id])
    assert capsys.readouterr().out == f"loaded adapter from {m.ckpt}\n{text}\n"
    assert text.count("<") >= 6                     # the ids show


@pytest.mark.parametrize("speculative", [0, 2])
def test_chat_demo_prints_the_direct_streams(loaded, capsys, monkeypatch, speculative):
    m = loaded
    turns = ["hello there", "and once more"]
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(turns) + "\n\n"))
    argv = ["--model_path", "hf", "--adapter_path", m.adapter, "--max_new_tokens", "10",
            "--device", "cpu"]
    chat_demo.main(argv + (["--speculative", str(speculative)] if speculative else []))
    want, history = "Chat ready — empty line to quit.\n", []
    for user in turns:
        history.append((user, ""))
        ids = [m.tok.bos_token_id] + m.tok.encode(chat_demo.build_prompt(history))
        kw = dict(max_new_tokens=10, eos_id=m.tok.eos_token_id, sparams=SAMPLE,
                  generator=torch.Generator().manual_seed(0), device="cpu")
        x, n = torch.tensor([ids]), torch.tensor([len(ids)])
        stream = (generate_stream_speculative(m.params, m.lora, x, n, m.cfg, m.lcfg,
                                              draft_len=speculative, **kw) if speculative
                  else generate_stream(m.params, m.lora, x, n, m.cfg, m.lcfg, **kw))
        printed, reply = streamed(m.tok, stream)
        want += f"you> bot> {printed}\n"
        history[-1] = (user, reply)
    assert capsys.readouterr().out == want + "you> "
    assert history[0][1].count("<") >= 3


def test_chat_demo_int8_builds_one_serving_copy(loaded, capsys, monkeypatch):
    from qlora_tpu_torch.generate import serve_int8

    made = []
    real = serve_int8.requantize_params_int8_unstacked
    monkeypatch.setattr(serve_int8, "requantize_params_int8_unstacked",
                        lambda p: made.append(1) or real(p))
    monkeypatch.setattr(sys, "stdin", io.StringIO("one\ntwo\nthree\n"))
    chat_demo.main(["--model_path", "hf", "--max_new_tokens", "4", "--decode_impl", "int8",
                    "--device", "cpu"])
    assert made == [1] and capsys.readouterr().out.count("bot> ") == 3


def test_serve_demo_prints_the_direct_batcher(loaded, capsys, tmp_path):
    m = loaded
    prompts = [f"request {i}: " + "abcdefghij" * (3 + i % 4) for i in range(6)]
    (tmp_path / "p.txt").write_text("\n".join(prompts) + "\n\n")
    serve_demo.main(["--model_path", "hf", "--adapter_path", m.adapter, "--prompts",
                     str(tmp_path / "p.txt"), "--num_slots", "2", "--n_pages", "20",
                     "--page_size", "8", "--max_pages_per_seq", "32", "--max_new_tokens", "24",
                     "--device", "cpu"])
    direct = PagedBatcher(m.params, m.lora, m.cfg, m.lcfg, num_slots=2, n_pages=20,
                          page_size=8, max_pages_per_seq=32, eos_id=m.tok.eos_token_id,
                          sparams=SAMPLE, device="cpu")
    reqs = {direct.submit([m.tok.bos_token_id] + m.tok.encode(p), max_new_tokens=24).uid: p
            for p in prompts}
    done = sorted(direct.run_to_completion(), key=lambda r: r.uid)
    assert direct.preemptions > 0                   # the same schedule preempted in main
    want = "".join(f"\n=== {reqs[r.uid]} ===\n{m.tok.decode(r.generated)}\n" for r in done)
    assert capsys.readouterr().out == want


def test_serve_demo_tensor_parallel_names_a7(loaded, capsys, tmp_path):
    """``--tp 2`` (ROADMAP A7a): two gloo ranks of its own, each a
    ``PagedBatcher(tp_mesh=...)`` over its shard of the model and adapter;
    rank 0's completions printed.  At temperature 0 each token is the argmax:
    equal to the single device's up to the first top-2 margin under 0.1
    (the two paths' logits differ by up to 0.04 at this size: the row-parallel
    linears re-packed per K-chunk, the all-reduce's order)."""
    m = loaded
    prompts = [f"request {i}: " + "abcdefghij" * (1 + i) for i in range(3)]
    (tmp_path / "p.txt").write_text("\n".join(prompts) + "\n")
    argv = ["--model_path", "hf", "--adapter_path", m.adapter, "--prompts",
            str(tmp_path / "p.txt"), "--num_slots", "2", "--n_pages", "20", "--page_size", "8",
            "--max_pages_per_seq", "32", "--max_new_tokens", "10", "--temperature", "0",
            "--device", "cpu"]
    done = serve_demo.main(argv + ["--tp", "2"])
    want = "".join(f"\n=== {prompts[uid - 1]} ===\n{m.tok.decode(g)}\n" for uid, g in done)
    assert capsys.readouterr().out == want and [uid for uid, _ in done] == [1, 2, 3]
    single = dict(serve_demo.main(argv))
    capsys.readouterr()
    compared = 0
    for uid, got in done:
        ids = [m.tok.bos_token_id] + m.tok.encode(prompts[uid - 1])
        ref = single[uid]
        assert len(got) == len(ref) == 10
        with torch.no_grad():
            logits = forward(m.params, m.lora, torch.tensor([ids + ref]), m.cfg,
                             m.lcfg)[0][0, len(ids) - 1:-1]
        top2 = logits.topk(2, dim=-1).values
        ties = ((top2[:, 0] - top2[:, 1]) < 0.1).nonzero()
        upto = int(ties[0]) if len(ties) else len(ref)
        assert got[:upto] == ref[:upto]
        compared += upto
    assert compared > 0


def test_examples_need_a_device_where_no_card_is_present(loaded, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        guanaco_generate.main(["--model_path", "hf"])


def test_prompt_template_and_build_prompts_are_jax_s():
    jg, jc, jw = (jax_example(n) for n in ("guanaco_generate", "chat_demo", "web_demo"))
    assert guanaco_generate.PROMPT_TEMPLATE == jg.PROMPT_TEMPLATE
    assert web_demo.PAGE == jw.PAGE
    for history in ([], [("hi", "")], [("hi", "hello"), ("how are you?", "")],
                    [("a\nb", "c ### d"), ("", "x"), ("ünï", "")]):
        assert chat_demo.build_prompt(history) == jc.build_prompt(history)
        assert web_demo.build_prompt(history, "bye") == jw.build_prompt(history, "bye")


# the four cases of tests/test_web_demo.py, on the port's web_demo --debug


def hook_server():
    hooked = []

    class Hook(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            hooked.append(json.loads(self.rfile.read(n)))
            self.send_response(200)
            self.end_headers()

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Hook)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}/", hooked


def chat(url, history, message):
    req = urllib.request.Request(url + "/chat",
                                 json.dumps({"history": history, "message": message}).encode(),
                                 {"Content-Type": "application/json"})
    body = urllib.request.urlopen(req, timeout=120).read().decode()
    return [json.loads(e[6:]) for e in body.split("\n\n") if e.startswith("data: ")]


@pytest.fixture(scope="module")
def server():
    args = Namespace(debug=True, model_path=None, adapter_path=None, temperature=0.7,
                     top_p=0.9, max_new_tokens=8, device="cpu")
    engine = web_demo.ChatEngine(args)
    hook_srv, webhook, hooked = hook_server()
    srv = ThreadingHTTPServer(("127.0.0.1", 0), web_demo.make_handler(engine, webhook))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", hooked, engine
    for s in (srv, hook_srv):
        s.shutdown()
        s.server_close()


def test_build_prompt_matches_notebook_format():
    p = web_demo.build_prompt([("hi", "hello")], "bye")
    assert p == "### Human: hi### Assistant: hello### Human: bye### Assistant:"


def test_index_page_served(server):
    url, _, _ = server
    html = urllib.request.urlopen(url + "/").read().decode()
    assert "qlora_tpu" in html and "/chat" in html


def test_chat_streams_sse_and_logs_webhook(server):
    url, hooked, engine = server
    events = chat(url, [["a", "b"]], "hi")
    assert events[-1] == {"done": True}
    deltas = [e["delta"] for e in events if "delta" in e]
    assert hooked and hooked[-1]["turn"][0] == "hi"
    assert hooked[-1]["turn"][1] == "".join(deltas)
    assert hooked[-1]["history"] == [["a", "b"]]
    assert "".join(engine.stream_reply([("a", "b")], "hi")) == "".join(deltas)


def test_stop_string_truncates_stream(server, monkeypatch):
    """stream_reply cuts at '### Human:' and never emits a partial stop
    prefix (the notebook's StoppingCriteria): the engine's own loop over a
    scripted token stream."""
    _, _, engine = server
    tok = FakeTokenizer()
    script = tok.encode("yes.### Human: sneak") + [tok.eos_token_id]
    monkeypatch.setattr(engine, "token_stream", lambda ids: ([t] for t in script))
    deltas = list(engine.stream_reply([], "hi"))
    assert "".join(deltas) == "yes."
    assert not any("#" in d for d in deltas)
    script[:] = tok.encode("one # two") + [tok.eos_token_id]
    assert "".join(engine.stream_reply([], "hi")) == "one # two"


def test_web_demo_server_streams_the_direct_reply(loaded):
    """make_server over the load helpers, as main builds it: two streamed
    chats, each logged to the webhook and equal to stream_reply called
    directly on the same engine."""
    m = loaded
    hook_srv, webhook, hooked = hook_server()
    srv = web_demo.make_server(web_demo.parse_args(
        ["--model_path", "hf", "--adapter_path", m.adapter, "--port", "0", "--max_new_tokens",
         "8", "--log_webhook", webhook, "--device", "cpu"]))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    engine = srv.engine
    try:
        history = []
        for message in ("first question", "second one"):
            events = chat(url, history, message)
            assert events[-1] == {"done": True}
            reply = "".join(e["delta"] for e in events if "delta" in e)
            assert reply == "".join(engine.stream_reply([tuple(t) for t in history], message))
            assert reply.count("<") >= 2
            assert hooked[-1] == {"history": history, "turn": [message, reply]}
            history = history + [[message, reply]]
        assert len(hooked) == 2
    finally:
        for s in (srv, hook_srv):
            s.shutdown()
            s.server_close()


def test_web_demo_main_prints_its_address(loaded, capsys, monkeypatch):
    class Stopped(ThreadingHTTPServer):
        def serve_forever(self, poll_interval=0.5):
            raise KeyboardInterrupt

    monkeypatch.setattr(web_demo, "ThreadingHTTPServer", Stopped)
    web_demo.main(["--debug", "--port", "0", "--device", "cpu"])
    assert capsys.readouterr().out.startswith("chat ui: http://127.0.0.1:")
    with pytest.raises(SystemExit):
        web_demo.parse_args(["--device", "cpu"])       # neither --model_path nor --debug
