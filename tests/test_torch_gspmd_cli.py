"""The CLI's full finetuning on a mesh (``--full_finetune --bits 16`` with
``--mesh_dp/--mesh_fsdp/--mesh_tp``: the GSPMD step) against the port's
single-card CLI on the same argv, the mirrors of the JAX package's
``test_cli_mesh_full_finetune`` and ``..._resume`` (tests/test_e2e.py)
at four gloo ranks on the CPU.

Held: each step's loss within 2e-3 relative and grad norm within 5e-3 of
the single card's (the JAX sharded steps' bounds); the mesh's checkpoint in
the single-device layout (the single card's keys, shapes and dtypes), read
by the single card for one more step against the single card's own; a
resumed mesh run picking up the RESTORED weights (JAX's regression:
steps 3 and 4 continue the single card's, the loss below its start)."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import qlora_tpu_torch.cli as cli
from qlora_tpu_torch.utils.checkpoint import read_arrays

torch.set_num_threads(2)
LOSS_RTOL, GNORM_RTOL = 2e-3, 5e-3


def _argv(data, out, steps, *extra):
    return ["--model_name_or_path", "debug", "--init_random", "--fake_tokenizer",
            "--dataset", data, "--output_dir", out, "--max_steps", str(steps),
            "--full_finetune", "--bits", "16", "--learning_rate", "5e-4",
            "--per_device_train_batch_size", "4", "--gradient_accumulation_steps", "2",
            "--source_max_len", "32", "--target_max_len", "16", "--logging_steps", "1",
            "--save_steps", "2", "--group_by_length", "false", "--do_eval", "false",
            "--device", "cpu", *extra]


def _steps(metrics):
    return [(h["step"], h["loss"], h["grad_norm"]) for h in metrics["train_metrics"]]


def _close(got, want, tag):
    assert [s for s, _, _ in got] == [s for s, _, _ in want], tag
    np.testing.assert_allclose([x[1] for x in got], [x[1] for x in want], rtol=LOSS_RTOL,
                               err_msg=tag)
    np.testing.assert_allclose([x[2] for x in got], [x[2] for x in want], rtol=GNORM_RTOL,
                               err_msg=tag)


MESHES = {"1x2x2": ["--mesh_fsdp", "2", "--mesh_tp", "2"],
          "2x2x1": ["--mesh_dp", "2", "--mesh_fsdp", "2"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gspmd_cli")
    rows = [{"input": f"Repeat the word apple {i} times" + " and pears" * (i % 3),
             "output": "apple " * (1 + i % 4)} for i in range(16)]
    data = str(tmp / "data.json")
    open(data, "w").write(json.dumps(rows))
    d = lambda tag: str(tmp / tag)

    out = {"dirs": d, "single": cli.main(_argv(data, d("single"), 4))}
    # (1, 2, 2): 4 steps (JAX's test_cli_mesh_full_finetune); (2, 2, 1): 2
    # steps, then resumed to 4, the restored weights sharded (its ..._resume)
    out["1x2x2"] = (cli.main(_argv(data, d("1x2x2"), 4, *MESHES["1x2x2"])),)
    first = cli.main(_argv(data, d("2x2x1"), 2, *MESHES["2x2x1"]))
    os.remove(os.path.join(d("2x2x1"), "completed"))
    out["2x2x1"] = (first, cli.main(_argv(data, d("2x2x1"), 4, *MESHES["2x2x1"])))
    # the single card's own fifth step, and the mesh's checkpoint-4 on one card for it
    shutil.copytree(d("single"), d("single5"))
    os.remove(os.path.join(d("single5"), "completed"))
    out["single5"] = cli.main(_argv(data, d("single5"), 5))
    os.remove(os.path.join(d("1x2x2"), "completed"))
    out["one"] = cli.main(_argv(data, d("1x2x2"), 5))
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
def test_full_finetune_mesh_matches_single_card_and_resumes(runs, mesh):
    """Every step's loss and grad norm against the single card's
    uninterrupted run: (1, 2, 2) for steps 1-4, the loss falling; (2, 2, 1)
    for steps 1-2, then a run resumed from its step-2 checkpoint to step 4
    (the restored weights, not a fresh init, sharded over the ranks), the
    resumed loss below the first."""
    single = _steps(runs["single"])
    if mesh == "1x2x2":
        (run,) = runs[mesh]
        _close(_steps(run), single, f"{mesh} steps 1-4")
        assert _steps(run)[-1][1] < _steps(run)[0][1]
        return
    first, second = runs[mesh]
    _close(_steps(first), single[:2], f"{mesh} steps 1-2")
    _close(_steps(second), single[2:], f"{mesh} resumed, steps 3-4")
    assert [s for s, _, _ in _steps(second)] == [3, 4]
    assert _steps(second)[0][1] < _steps(first)[0][1]


def test_mesh_checkpoint_is_single_device_layout_and_resumes_on_one_card(runs):
    """Rank 0's checkpoint-4 of the (1, 2, 2) run holds the single card's
    keys, shapes and dtypes (the model and AdamW's moments gathered a tensor
    at a time), the weights near the single card's; read by the single
    card for step 5, against the single card's own step 5."""
    d = runs["dirs"]
    for part in (os.path.join("adapter_model", "adapter_weights.npz"), "optimizer_state.npz"):
        got = read_arrays(os.path.join(d("1x2x2"), "checkpoint-4", part))
        want = read_arrays(os.path.join(d("single"), "checkpoint-4", part))
        assert got.keys() == want.keys(), part
        for k in want:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, (part, k)
            if part.startswith("adapter") and want[k].dtype.is_floating_point:
                diff = (got[k].float() - want[k].float()).norm()
                assert diff <= 2e-2 * want[k].float().norm() + 1e-6, k
    _close(_steps(runs["one"]), _steps(runs["single5"]), "the mesh checkpoint on one card")
    assert [s for s, _, _ in _steps(runs["one"])] == [5]
