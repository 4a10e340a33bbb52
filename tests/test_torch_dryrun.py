"""The multi-rank dry run (``qlora_tpu_torch.dryrun``), the JAX package's
``dryrun_multichip`` (``__graft_entry__.py``): every path JAX's dry run
takes at n = 4, one step each at its tiny shapes, in one world of four gloo
ranks on the CPU, each with JAX's assertions (finite positive losses,
finite logits, every request served, every page recycled, KV shards of
KVH/tp heads: inside the ranks, whose failure fails the run)."""

import pytest
import torch

from qlora_tpu_torch import dryrun
import torch_train_worker

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def run():
    return dryrun.dryrun_multichip(4, "cpu", probe=torch_train_worker.path_probe)


def test_every_path_jax_runs_at_four(run):
    """n = 4 factors as JAX's: (dp, fsdp, tp) = (1, 2, 2); the paths JAX
    runs there, in its order (the weight-sharded ring needs n % 8 == 0 and
    is skipped, as JAX skips it), on every rank, the probe called after
    each."""
    assert dryrun._factor(4) == (1, 2, 2) and dryrun._factor(8) == (2, 2, 2)
    assert dryrun._factor(2) == (1, 1, 2) and dryrun._factor(3) == (3, 1, 1)
    want = ("gspmd", "sharded", "megatron", "ring", "tp-serving", "paged-tp")
    assert len(run) == 4
    for lines in run:
        assert tuple(name for name, *_ in lines) == want
        assert [seen for *_, seen in lines] == [("end", n) for n in want]
    text = {name: line for name, line, *_ in run[0]}
    assert "mesh=MeshAxes(dp=1, fsdp=2, tp=2)" in text["gspmd"]
    assert "zero1=True" in text["sharded"]
    assert text["paged-tp"].endswith("18 tokens served")      # 3 requests x 6


def test_losses_agree_across_ranks(run):
    """Every rank reports the same line (the same losses) for every path."""
    for lines in run[1:]:
        assert [line for _, line, *_ in lines] == [line for _, line, *_ in run[0]]


def test_ranks_for_names_backend_and_devices(monkeypatch):
    """The CPU: gloo on the CPU; a card a rank: NCCL; fewer cards: gloo
    ranks sharing the first card (never a silent move to the CPU)."""
    assert dryrun.ranks_for(4, "cpu") == ("gloo", ["cpu"] * 4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert dryrun.ranks_for(4, "cuda") == ("nccl", [f"cuda:{r}" for r in range(4)])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert dryrun.ranks_for(4, "cuda") == ("gloo", ["cuda:0"] * 4)
