"""Several processes (hosts) joined through a TCP coordinator
(``parallel.distributed.initialize``): two processes of two gloo ranks
each on the CPU form one 4-rank world, as the JAX package's two-process
skeleton (tests/test_multihost.py) forms one pod.

Each process (tests/torch_multihost_worker.py) runs, in one world, the
sharded step at (dp, fsdp, tp) = (2, 1, 2) on the global batch assembled
from its own rows (``global_batch_from_local``) and the GSPMD step on the
dense model, then the CLI's full finetuning with the coordinator flags (a
second world).  Held: every loss and grad norm equal, bit for bit, to the
same mesh run as one process (the rendezvous differs, the collectives do
not); the sharded step within JAX's rtol 2e-3 / 5e-3 of JAX's
single-process step; global ranks process-major (``process_info``);
``make_global_mesh`` warning where fsdp×tp groups span processes, and only
there; only process 0 writing the CLI's files."""

import json
import os
import pickle
import socket
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qlora_tpu.lora import LoraConfig as JLoraConfig
from qlora_tpu.models import init_lora_params as jinit_lora
from qlora_tpu.models import init_params as jinit_params
from qlora_tpu.models.config import ModelConfig as JModelConfig
from qlora_tpu.train import init_train_state as jinit_train_state
from qlora_tpu.train import make_optimizer as jmake_optimizer
from qlora_tpu.train import make_train_step as jmake_train_step

import qlora_tpu_torch.cli as cli
from qlora_tpu_torch.models.config import ModelConfig
from qlora_tpu_torch.parallel import distributed, run_ranks
from test_torch_convert import jax_to_numpy
import torch_train_worker

torch.set_num_threads(2)

# JAX's multi-host test model (tests/test_multihost.py)
CFG = dict(arch="llama", vocab_size=512, hidden_size=256, intermediate_size=512,
           num_layers=2, num_heads=4, num_kv_heads=4)
LCFG = dict(r=4, alpha=8)
LOSS_RTOL, GNORM_RTOL = 2e-3, 5e-3
SHAPE, STEPS, NPROC = (2, 1, 2), 2, 2


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _cli_argv(data, out):
    return ["--model_name_or_path", "debug", "--init_random", "--fake_tokenizer",
            "--dataset", data, "--output_dir", out, "--max_steps", "2", "--full_finetune",
            "--bits", "16", "--learning_rate", "5e-4", "--per_device_train_batch_size", "4",
            "--gradient_accumulation_steps", "1", "--source_max_len", "32",
            "--target_max_len", "16", "--logging_steps", "1", "--save_steps", "100",
            "--group_by_length", "false", "--do_eval", "false", "--mesh_dp", "2",
            "--mesh_tp", "2", "--device", "cpu"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost")
    jcfg = JModelConfig(**CFG)
    nf4 = jinit_params(jax.random.PRNGKey(0), jcfg, quantized=True)
    dense = jinit_params(jax.random.PRNGKey(0), jcfg, quantized=False)
    lora = jinit_lora(jax.random.PRNGKey(1), jcfg, JLoraConfig(**LCFG))
    rng = np.random.default_rng(1)
    lora = {n: {"a": ad["a"], "b": jnp.asarray(rng.normal(size=ad["b"].shape) * 0.05,
                                               jnp.float32)} for n, ad in lora.items()}
    ids = np.random.default_rng(2).integers(0, CFG["vocab_size"], (8, 16)).astype(np.int32)
    batch = {"input_ids": ids, "attention_mask": np.ones_like(ids), "labels": ids}
    cfg = ModelConfig(**CFG)
    common = dict(cfg=cfg, lcfg_kw=LCFG, shape=SHAPE, steps=STEPS)

    def cases(local_batch):
        return [("step", "multihost", dict(common, local_batch=local_batch,
                                           params_np=jax_to_numpy(nf4),
                                           lora_np=jax_to_numpy(lora),
                                           spans_of=[(1, 2, 2), (2, 1, 2), (4, 1, 1)])),
                ("gspmd", "gspmd", dict(common, batch=batch, params_np=jax_to_numpy(dense),
                                        lora_np=None))]

    rows = len(ids) // NPROC
    rows_of = lambda p: {k: v[p * rows:(p + 1) * rows] for k, v in batch.items()}
    examples = [{"input": f"Repeat the word apple {i} times" + " and pears" * (i % 3),
                 "output": "apple " * (1 + i % 4)} for i in range(16)]
    data = str(tmp / "data.json")
    open(data, "w").write(json.dumps(examples))
    job = str(tmp / "job.pkl")
    with open(job, "wb") as f:
        pickle.dump(dict(world=4, cases=[cases(rows_of(p)) for p in range(NPROC)],
                         cli_argv=_cli_argv(data, str(tmp / "two"))), f)
    # the same mesh as one process, and JAX's single-process step
    with tempfile.TemporaryDirectory() as store:
        one = run_ranks(torch_train_worker.world, 4, cases(batch), backend="gloo",
                        devices=["cpu"] * 4, store_dir=store, timeout_s=600)
    one_cli = cli.main(_cli_argv(data, str(tmp / "one")))
    opt = jmake_optimizer("paged_adamw_32bit", 1e-3, total_steps=10)
    step = jmake_train_step(jcfg, JLoraConfig(**LCFG), opt, donate=False)
    state = jinit_train_state(lora, opt)
    ref = {"loss": [], "grad_norm": []}
    for i in range(STEPS):
        state, m = step(state, nf4, {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.PRNGKey(50 + i))
        ref["loss"].append(float(m["loss"]))
        ref["grad_norm"].append(float(m["grad_norm"]))
    # then the two processes
    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__), "torch_multihost_worker.py")
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS",)}
    procs = [subprocess.Popen([sys.executable, worker, str(p), str(NPROC), str(port), job,
                               str(tmp / f"out{p}.pkl")], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for p in range(NPROC)]
    try:
        logs = [p.communicate(timeout=300)[0].decode(errors="replace") for p in procs]
        assert all(p.returncode == 0 for p in procs), "\n".join(l[-3000:] for l in logs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    two = [pickle.load(open(tmp / f"out{p}.pkl", "rb")) for p in range(NPROC)]
    return dict(one=one, one_cli=one_cli, two=two, ref=ref, tmp=tmp)


def test_two_processes_equal_one_process_bit_for_bit(runs):
    """The sharded step on the global batch assembled from each process's
    rows, and the GSPMD step: every rank's losses and grad norms equal the
    same mesh's run as one process (the tolerance held: 0, bit-equal)."""
    two = [r for proc in runs["two"] for r in proc["ranks"]]
    assert len(two) == 4
    for case in ("step", "gspmd"):
        for r, (a, b) in enumerate(zip(two, runs["one"])):
            assert a[case]["loss"] == b[case]["loss"], (case, r)
            assert a[case]["grad_norm"] == b[case]["grad_norm"], (case, r)
    for r, (a, b) in enumerate(zip(two, runs["one"])):
        assert a["step"]["batch_sum"] == b["step"]["batch_sum"] == int(
            runs["one"][0]["step"]["batch_sum"])


def test_two_processes_match_jax_single_process(runs):
    """The sharded step across the two processes against JAX's
    single-process step (JAX's multi-host bounds: rtol 2e-3 loss, 5e-3 grad
    norm)."""
    got = runs["two"][1]["ranks"][1]["step"]
    np.testing.assert_allclose(got["loss"], runs["ref"]["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], runs["ref"]["grad_norm"], rtol=GNORM_RTOL)


def test_global_ranks_are_process_major_and_spans_warn(runs):
    """Process p's local rank l is world rank p·L + l; ``process_info`` in a
    rank names its process, 2 processes, 2 local and 4 global ranks;
    ``make_global_mesh`` warns for (1, 2, 2) (a group of 4 over both
    processes), not for (2, 1, 2) or (4, 1, 1); one process never warns."""
    for p, proc in enumerate(runs["two"]):
        for l, r in enumerate(proc["ranks"]):
            step = r["step"]
            assert step["rank"] == p * 2 + l
            assert step["info"] == dict(process_id=p, process_count=2, local_devices=2,
                                        global_devices=4)
            assert step["warned"] == {(1, 2, 2): True, (2, 1, 2): False, (4, 1, 1): False}
    for r in runs["one"]:
        assert not any(r["step"]["warned"].values())
        assert r["step"]["info"]["process_count"] == 1


def test_cli_over_two_processes(runs):
    """``--coordinator_address/--num_processes/--process_id`` on the CLI's
    full-finetune mesh: one world across the processes, the losses of the
    same run as one process; process 0 writes the log, the checkpoint and
    ``metrics.json``, process 1 returns its id and writes nothing."""
    p0, p1 = (proc["cli"] for proc in runs["two"])
    steps = lambda m: [(h["step"], h["loss"], h["grad_norm"]) for h in m["train_metrics"]]
    assert steps(p0) == steps(runs["one_cli"])
    assert p1 == {"run_name": str(runs["tmp"] / "two"), "process": 1}
    two = runs["tmp"] / "two"
    assert json.loads((two / "metrics.json").read_text())["train_metrics"] == p0["train_metrics"]
    assert (two / "checkpoint-2").is_dir() and (two / "completed").exists()


def test_initialize_without_a_run_starts_nothing():
    """No arguments, or one process: nothing joined (False); a partial
    request is refused, as no runtime discovers the rest."""
    assert distributed.initialize() is False
    assert distributed.initialize(num_processes=1) is False
    assert distributed.process_count() == 1 and distributed.process_index() == 0
    with pytest.raises(ValueError, match="together"):
        distributed.initialize(coordinator_address="localhost:1", num_processes=2)
    with pytest.raises(ValueError, match="host:port"):
        distributed.initialize("localhost", 2, 0)
