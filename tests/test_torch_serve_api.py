"""The port's OpenAI-compatible endpoint (``qlora_tpu_torch.serve_openai``)
over real HTTP on the CPU ``debug`` model: the seven cases with which
tests/test_serve_api.py drives the JAX endpoint, the port's greedy
completions against the JAX endpoint's on the same weights, and an engine
thread that fails.

Completions are compared up to the first near-tie: a position whose top-2
logits, teacher-forced through the port's plain forward, lie within
``MARGIN`` of each other (twice the logits' atol against JAX,
test_torch_model), where bf16 rounded in another order may pick the other
token."""

import argparse
import json
import os
import sys
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import pytest
import torch

from qlora_tpu.models import get_config as jget_config
from qlora_tpu.models import init_params as jinit_params

from qlora_tpu_torch.models import forward, get_config
from qlora_tpu_torch.serve_openai import ServingEngine, make_handler, parse_args
from qlora_tpu_torch.utils import FakeTokenizer
from test_torch_convert import bridge

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

torch.set_num_threads(2)
MARGIN = 0.2
ENGINE = ["--slots", "3", "--n_pages", "64", "--max_pages_per_seq", "8", "--speculative", "2",
          "--steps_per_dispatch", "2", "--admit_batch", "2"]


def _serve(engine):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(engine))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def server():
    engine = ServingEngine.from_args(parse_args(["--debug", "--device", "cpu"] + ENGINE))
    srv, url = _serve(engine)
    yield url
    srv.shutdown()
    srv.server_close()
    engine.shutdown()
    assert engine.error is None


def _post(url, payload, timeout=300, path="/v1/completions"):
    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def test_models_endpoint(server):
    d = json.loads(urllib.request.urlopen(server + "/v1/models").read())
    assert d["data"][0]["id"] == "debug"


def test_completion_non_streaming(server):
    d = json.loads(_post(server, {"prompt": "hello there", "max_tokens": 6}).read())
    assert d["object"] == "text_completion"
    assert d["choices"][0]["finish_reason"] == "stop"
    assert d["usage"]["completion_tokens"] <= 6
    assert d["usage"]["prompt_tokens"] == len("hello there")


def test_completion_streaming_sse(server):
    body = _post(server, {"prompt": "abc", "max_tokens": 5, "stream": True}).read().decode()
    events = [ln[6:] for ln in body.splitlines() if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    assert chunks[-1]["choices"][0]["finish_reason"] == "stop"
    assert all(c["object"] == "text_completion" for c in chunks)


def test_concurrent_clients_share_engine(server):
    results = {}

    def one(i):
        results[i] = json.loads(_post(server, {"prompt": f"client {i} says",
                                               "max_tokens": 4}).read())

    ts = [threading.Thread(target=one, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
    assert len(results) == 4
    for d in results.values():
        assert d["choices"][0]["finish_reason"] == "stop"
        assert 0 < d["usage"]["completion_tokens"] <= 4


def test_mismatched_sampling_params_rejected(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, {"prompt": "x", "max_tokens": 2, "temperature": 0.7})
    assert e.value.code == 400


def test_chat_completion_non_streaming(server):
    d = json.loads(_post(server, {"messages": [
        {"role": "system", "content": "Be terse."},
        {"role": "user", "content": "hi"}], "max_tokens": 6},
        path="/v1/chat/completions").read())
    assert d["object"] == "chat.completion"
    m = d["choices"][0]["message"]
    assert m["role"] == "assistant"
    assert "### Human:" not in m["content"]
    assert d["choices"][0]["finish_reason"] == "stop"


def test_chat_completion_streaming(server):
    body = _post(server, {"messages": [{"role": "user", "content": "hello"}],
                          "max_tokens": 6, "stream": True},
                 path="/v1/chat/completions").read().decode()
    events = [ln[6:] for ln in body.splitlines() if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)
    text = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
    assert "### Human:" not in text
    assert chunks[-1]["choices"][0]["finish_reason"] == "stop"


def _tokens(engine, prompts, n):
    queues = [engine.submit(list(p), n)[1] for p in prompts]
    out = []
    for q in queues:
        toks = []
        while (t := q.get(timeout=600)) is not None:
            toks.append(t)
        out.append(toks)
    return out


def test_greedy_completions_match_the_jax_endpoint():
    from serve_openai import ServingEngine as JServingEngine

    jargs = argparse.Namespace(
        model_path=None, adapter_path=None, debug=True, slots=3, n_pages=64,
        max_pages_per_seq=8, temperature=0.0, top_p=1.0, decode_impl=None, speculative=2,
        steps_per_dispatch=2, admit_batch=2)
    jengine = JServingEngine(jargs)      # its params: init_params(PRNGKey(0), quantized=True)
    cfg = get_config("debug")
    params, _ = bridge(jinit_params(jax.random.PRNGKey(0), jget_config("debug"),
                                    quantized=True), None, cfg)
    engine = ServingEngine(params, None, cfg, FakeTokenizer(), slots=3, n_pages=64,
                           page_size=8, max_pages_per_seq=8, prefill_buckets=(16, 32),
                           speculative=2, steps_per_dispatch=2, admit_batch=2, device="cpu")
    tok = FakeTokenizer()
    prompts = [tok.encode(t) for t in ("The quick brown fox", "hello there",
                                       "### Human: hi\n### Assistant:")]
    try:
        want, got = _tokens(jengine, prompts, 12), _tokens(engine, prompts, 12)
    finally:
        jengine.shutdown()
        engine.shutdown()
    assert engine.error is None
    clear = 0
    for p, w, g in zip(prompts, want, got):
        ids = torch.tensor([p + w])
        with torch.inference_mode():
            logits = forward(params, None, ids, cfg)[0][0, len(p) - 1:-1]
        top2 = logits.topk(2, dim=-1).values
        ties = ((top2[:, 0] - top2[:, 1]) <= MARGIN).nonzero()
        upto = int(ties[0]) if len(ties) else len(w)
        assert g[:upto] == w[:upto], (p, upto)
        if upto == len(w):
            assert g == w
        clear += upto
    assert clear > 0


def test_a_failing_engine_ends_the_streams_and_keeps_its_error():
    engine = ServingEngine.from_args(parse_args(["--debug", "--device", "cpu"] + ENGINE))
    boom = RuntimeError("step failed")

    def step():
        raise boom

    engine.pb.step = step
    srv, url = _serve(engine)
    try:
        d = json.loads(_post(url, {"prompt": "hello", "max_tokens": 4}).read())
        assert d["usage"]["completion_tokens"] == 0
        engine.thread.join(timeout=60)
        assert not engine.thread.is_alive() and engine.error is boom
        body = _post(url, {"prompt": "again", "max_tokens": 4, "stream": True}).read().decode()
        assert body.splitlines()[-2:] == ["data: [DONE]", ""]
    finally:
        srv.shutdown()
        srv.server_close()
        engine.shutdown()
