"""One process (a host) of tests/test_torch_multihost.py's two-process run:
it joins the run through the coordinator (``parallel.distributed.initialize``),
starts its two ranks of a 4-rank gloo world on the CPU for the rank
functions of tests/torch_train_worker.py, then trains through the CLI with
the coordinator flags (a second world), and pickles what it got.  Not
collected by pytest; it imports torch, numpy and the port only.

Usage: python torch_multihost_worker.py <process id> <processes> <port> <job.pkl> <out.pkl>
"""

import os
import pickle
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))


def main():
    import torch

    torch.set_num_threads(1)
    from qlora_tpu_torch import cli
    from qlora_tpu_torch.parallel import distributed, run_ranks
    import torch_train_worker

    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    with open(sys.argv[4], "rb") as f:
        job = pickle.load(f)
    address = f"localhost:{port}"
    assert distributed.initialize(address, nproc, pid)
    local = job["world"] // nproc
    with tempfile.TemporaryDirectory() as tmp:
        ranks = run_ranks(torch_train_worker.world, job["world"], job["cases"][pid],
                          backend="gloo", devices=["cpu"] * local, store_dir=tmp, timeout_s=600)
    metrics = cli.main(job["cli_argv"] + ["--coordinator_address", address, "--num_processes",
                                          str(nproc), "--process_id", str(pid)])
    with open(sys.argv[5], "wb") as f:
        pickle.dump(dict(ranks=ranks, cli=metrics), f)


if __name__ == "__main__":
    main()
