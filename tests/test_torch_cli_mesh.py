"""The CLI's mesh branches (``--mesh_dp/--mesh_fsdp/--mesh_tp``, both
``--tp_style``s, and ``--mesh_sp``: the sequence-parallel step) against the
JAX package's CLI on the same argv.

Both CLIs train the debug model from a store JAX wrote and resume from
one single-device checkpoint JAX wrote at step 1 (so that both start from
the same adapters and optimizer state: their random LoRA initializations
differ), on the same alpaca file, whose data plan both CLIs share
(test_torch_cli.py holds ``_iter_batches`` to JAX's).  The port runs four
gloo ranks on the CPU (``--device cpu``), JAX its shard_map steps on the
conftest's virtual devices.  Held: each step's loss within 2e-3 relative
and grad norm within 5e-3 (the JAX sharded steps' bounds), the checkpoint
the mesh run writes (JAX's keys and shapes, the adapters within 5e-3 of
JAX's), and that checkpoint resumed on one device for a step, against JAX's
resumed likewise."""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import qlora_tpu.cli as jcli
from qlora_tpu.models import get_config as jget_config
from qlora_tpu.models import init_params as jinit_params
from qlora_tpu.utils.quantized_store import save_quantized as jsave_quantized

import qlora_tpu_torch.cli as cli
from qlora_tpu_torch.utils.checkpoint import read_arrays
import torch_train_worker

torch.set_num_threads(2)
LOSS_RTOL, GNORM_RTOL = 2e-3, 5e-3
MESHES = {"gather": ["--mesh_fsdp", "2", "--mesh_tp", "2"],
          "megatron": ["--tp_style", "megatron", "--mesh_dp", "2", "--mesh_tp", "2"],
          # (dp, sp) = (2, 2); 47 + 24 = 71 positions, padded to 72 for the ring
          "sp": ["--mesh_dp", "2", "--mesh_sp", "2", "--source_max_len", "47"]}


def _argv(store, data, out, steps, *extra):
    """The runs' flags; `extra` comes last, so that a run's own flags (the
    sp run's odd length) override these."""
    return ["--model_name_or_path", store, "--fake_tokenizer", "--dataset", data,
            "--output_dir", out, "--max_steps", str(steps), "--per_device_train_batch_size", "4",
            "--gradient_accumulation_steps", "2", "--source_max_len", "48",
            "--target_max_len", "24", "--logging_steps", "1", "--save_steps", "100",
            "--learning_rate", "1e-3", "--lora_r", "8", "--group_by_length", "false",
            "--do_eval", "false", *extra]


def _steps(metrics):
    return [(h["step"], h["loss"], h["grad_norm"]) for h in metrics["train_metrics"]]


def _close(got, want, tag):
    assert [s for s, _, _ in got] == [s for s, _, _ in want], tag
    np.testing.assert_allclose([x[1] for x in got], [x[1] for x in want], rtol=LOSS_RTOL,
                               err_msg=tag)
    np.testing.assert_allclose([x[2] for x in got], [x[2] for x in want], rtol=GNORM_RTOL,
                               err_msg=tag)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_cli")
    jcfg = jget_config("debug")
    store = str(tmp / "store")
    jsave_quantized(store, jinit_params(jax.random.PRNGKey(0), jcfg, quantized=True), jcfg)
    rows = [{"input": f"Repeat the word apple {i} times" + " and pears" * (i % 3),
             "output": "apple " * (1 + i % 4)} for i in range(24)]
    data = str(tmp / "data.json")
    open(data, "w").write(json.dumps(rows))
    start = str(tmp / "start")
    jcli.train(jcli.parse_args(_argv(store, data, start, 1)))
    out = {}
    for style, flags in MESHES.items():
        got = {}
        for who, run in (("jax", lambda a: jcli.train(jcli.parse_args(a))),
                         ("port", lambda a: cli.main(a + ["--device", "cpu"]))):
            d = str(tmp / f"{who}-{style}")
            shutil.copytree(os.path.join(start, "checkpoint-1"), os.path.join(d, "checkpoint-1"))
            mesh = run(_argv(store, data, d, 4, *flags))
            os.remove(os.path.join(d, "completed"))
            # the mesh checkpoint on one device, on the mesh run's data
            one = run(_argv(store, data, d, 5, *flags[flags.index("--source_max_len"):]
                            if "--source_max_len" in flags else ()))
            got[who] = (mesh, one, d)
        out[style] = got
    return out


@pytest.mark.parametrize("style", list(MESHES))
def test_mesh_cli_losses_match_jax_cli(runs, style):
    """Steps 2-4 on the mesh (resumed from JAX's step-1 checkpoint), each
    step's loss and grad norm against JAX's CLI on the same argv."""
    jax_run, port_run = runs[style]["jax"][0], runs[style]["port"][0]
    _close(_steps(port_run), _steps(jax_run), style)
    assert [s for s, _, _ in _steps(port_run)] == [2, 3, 4]
    log = [json.loads(line) for line in open(os.path.join(runs[style]["port"][2],
                                                           "train_log.jsonl"))]
    assert [(r["step"], r["loss"]) for r in log if "loss" in r][:3] == \
        [(s, loss) for s, loss, _ in _steps(port_run)]        # rank 0 wrote the log


@pytest.mark.parametrize("style", list(MESHES))
def test_mesh_checkpoint_is_jax_layout_and_resumes_on_one_device(runs, style):
    """Rank 0 writes checkpoint-4 in the single-device layout: JAX's keys,
    shapes and dtypes, the adapters near JAX's; each resumes on one device
    for step 5, the port's against JAX's."""
    pdir, jdir = runs[style]["port"][2], runs[style]["jax"][2]
    for part in (os.path.join("adapter_model", "adapter_weights.npz"), "optimizer_state.npz"):
        got = read_arrays(os.path.join(pdir, "checkpoint-4", part))
        want = read_arrays(os.path.join(jdir, "checkpoint-4", part))
        assert got.keys() == want.keys(), part
        for k in want:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, (part, k)
        if part.startswith("adapter"):
            for k in want:
                np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=5e-3,
                                           err_msg=k)
    one_port, one_jax = runs[style]["port"][1], runs[style]["jax"][1]
    assert [s for s, _, _ in _steps(one_port)] == [5]
    _close(_steps(one_port), _steps(one_jax), f"{style}: resumed on one device")


def test_train_takes_the_callers_ranks_model_and_hook(tmp_path):
    """``cli.train(args, ranks=..., model=..., hook=...)``: the ranks the
    caller names, the model it built (the mesh's first loss is the single
    device's on it), and a module-level hook that every rank calls at
    "start", after each "step" and at the "end", its reports returned in
    rank order and kept out of metrics.json.  The eval and MMLU of the loop
    run on the ranks' shards; the final eval, in the parent on the gathered
    adapters, reads what they read at the last step."""
    data = str(tmp_path / "data.json")
    open(data, "w").write(json.dumps([{"input": f"Repeat apple {i}", "output": "apple " * 3}
                                      for i in range(16)]))
    mmlu = tmp_path / "mmlu.json"
    mmlu.write_text(json.dumps([{"subject": "s", "input": "Which? Answer:", "output": "A"},
                                {"subject": "s", "input": "Pick. Answer:", "output": "B"}]))
    argv = ["--model_name_or_path", "debug", "--init_random", "--fake_tokenizer", "--dataset",
            data, "--max_steps", "2", "--per_device_train_batch_size", "4",
            "--gradient_accumulation_steps", "1", "--source_max_len", "32",
            "--target_max_len", "16", "--logging_steps", "1", "--device", "cpu", "--seed", "3",
            "--do_eval", "--eval_dataset_size", "4", "--eval_steps", "2", "--do_mmlu_eval",
            "--mmlu_data_path", str(mmlu), "--mmlu_source_max_len", "64"]
    args = cli.parse_args(argv + ["--output_dir", str(tmp_path / "a")])
    model = cli.build_model_and_tokenizer(args, "cpu")
    mesh = cli.train(cli.parse_args(argv + ["--output_dir", str(tmp_path / "a"),
                                            "--tp_style", "megatron", "--mesh_dp", "2",
                                            "--mesh_tp", "2"]),
                     ranks=("gloo", ["cpu"] * 4), model=model,
                     hook=torch_train_worker.record_hook)
    one = cli.train(cli.parse_args(argv + ["--output_dir", str(tmp_path / "b")]), model=model)
    reports = mesh["mesh_report"]
    assert [r["rank"] for r in reports] == [0, 1, 2, 3]
    losses = [h["loss"] for h in mesh["train_metrics"]]
    for r in reports:
        assert r["events"] == [("start", 0), ("step", 1), ("step", 2), ("end", 2)]
        assert r["losses"] == losses
    np.testing.assert_allclose(losses[0], one["train_metrics"][0]["loss"], rtol=LOSS_RTOL)
    assert "mesh_report" not in json.load(open(tmp_path / "a" / "metrics.json"))
    log = [json.loads(line) for line in open(tmp_path / "a" / "train_log.jsonl")]
    in_loop = [r for r in log if "eval_loss" in r or "mmlu_loss" in r]
    assert [(r["step"], sorted(k for k in r if k in ("eval_loss", "mmlu_loss")))
            for r in in_loop] == [(2, ["eval_loss"]), (2, ["mmlu_loss"])]
    np.testing.assert_allclose(in_loop[0]["eval_loss"], mesh["eval_loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(in_loop[1]["mmlu_loss"], one["mmlu_loss"], rtol=LOSS_RTOL)


def test_a_failed_cut_stops_the_waiting_ranks(tmp_path, monkeypatch):
    """The ranks start while the parent cuts their shards; when the cutting
    fails, the ranks stop waiting and the parent raises its own error."""
    import qlora_tpu_torch.parallel as parallel

    def broken(*a, **kw):
        raise ValueError("no shard")

    monkeypatch.setattr(parallel, "shard_sharded_params", broken)
    data = str(tmp_path / "data.json")
    open(data, "w").write(json.dumps([{"input": "a", "output": "b"}] * 8))
    with pytest.raises(ValueError, match="no shard"):
        cli.main(["--model_name_or_path", "debug", "--init_random", "--fake_tokenizer",
                  "--dataset", data, "--output_dir", str(tmp_path / "out"), "--max_steps", "1",
                  "--per_device_train_batch_size", "2", "--mesh_fsdp", "2", "--mesh_tp", "2",
                  "--device", "cpu"])
