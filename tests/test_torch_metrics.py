"""The port's metrics hooks against the JAX package's
(``qlora_tpu_torch/utils/metrics.py``): the jsonl lines, StepTimer's
warm-up skip, and a ``torch.profiler`` trace on the CPU."""

import json
import os
import time

import pytest
import torch

from qlora_tpu.utils.metrics import MetricsLogger as JMetricsLogger
from qlora_tpu.utils.metrics import StepTimer as JStepTimer

from qlora_tpu_torch.utils import MetricsLogger, StepTimer, maybe_profile

ROWS = [({"loss": 1.5, "grad_norm": 0.25}, 1), ({"loss": 1.2, "lr": 2e-4}, 2),
        ({"eval_loss": 0.9}, None), ({"loss": float("inf"), "note": "x"}, 3)]


def _lines(cls, out):
    ml = cls(out, report_to="none")
    for metrics, step in ROWS:
        ml.log(metrics, step=step)
    ml.close()
    with open(os.path.join(out, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_jsonl_lines_are_jax_s_but_for_the_time(tmp_path):
    mine = _lines(MetricsLogger, str(tmp_path / "port"))
    theirs = _lines(JMetricsLogger, str(tmp_path / "jax"))
    assert len(mine) == len(ROWS)
    for a, b in zip(mine, theirs):
        assert isinstance(a.pop("ts"), float) and isinstance(b.pop("ts"), float)
        assert a == b and list(a) == list(b)
    # a second logger appends, as JAX's does
    more = _lines(MetricsLogger, str(tmp_path / "port"))
    assert len(more) == 2 * len(ROWS)


def test_wandb_missing_falls_back_to_jsonl(tmp_path, monkeypatch):
    import builtins

    real = builtins.__import__

    def no_wandb(name, *a, **kw):
        if name == "wandb":
            raise ImportError("No module named 'wandb'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_wandb)
    ml = MetricsLogger(str(tmp_path), report_to="wandb")
    ml.log({"loss": 1.0}, step=1)
    ml.close()
    assert json.loads((tmp_path / "train_log.jsonl").read_text())["loss"] == 1.0


@pytest.mark.parametrize("skip,n", [(2, 4), (0, 3), (5, 3)])
def test_step_timer_skips_warmup_as_jax_s(skip, n):
    mine, theirs = StepTimer(skip_first=skip), JStepTimer(skip_first=skip)
    for _ in range(n):
        for t in (mine, theirs):
            t.tick()
            time.sleep(0.002)
            assert t.tock() >= 0.002
    assert len(mine.times) == len(theirs.times) == max(0, n - skip)
    assert (mine.mean > 0) == (theirs.mean > 0) == (n > skip)


def test_step_timer_synchronizes_a_cuda_device_only(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(a))
    t = StepTimer(skip_first=0, device="cpu")
    t.tick()
    t.tock()
    assert calls == []
    t = StepTimer(skip_first=0, device="cuda")
    t.tick()
    t.tock()
    assert len(calls) == 2


def test_maybe_profile_writes_a_trace_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    with maybe_profile(str(tmp_path), False) as prof:
        assert prof is None
    assert not (tmp_path / "profile").exists()
    with maybe_profile(str(tmp_path), True) as prof:
        for _ in range(3):
            x = torch.tanh(x @ x)
    trace = tmp_path / "profile" / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in a.key for a in prof.key_averages())
