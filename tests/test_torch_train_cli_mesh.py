"""The train CLI (``repro_torch.launch.train.main``) on a mesh of two gloo
ranks (EP 2) on the CPU, as ``torchrun`` starts it (env://).

The run takes the reference's layout (each rank holds a shard of the
dense weights): the residual stream is each rank's shard of the sequence
where the sequence divides by the EP axis, and whole on every rank where
it does not.  Either way a dense model's losses equal the one-process
run's within the fp32 tolerance of the mesh tests.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--arch", "qwen3-0.6b", "--reduce", "--device", "cpu", "--batch",
        "2", "--steps", "2", "--ckpt-every", "0", "--log-every", "100"]
TOL = 1e-5


def _worker(rank, world, port, seq, out_dir):
    import torch

    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    from repro_torch.launch.train import main

    run = main(ARGS + ["--seq", str(seq), "--ep", str(world)])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             losses=np.array(run.losses), params=run.params)


def _spawn(seq, out_dir):
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_worker, args=(2, port, seq, out_dir), nprocs=2, join=True)


@pytest.mark.parametrize("seq, divides", [(16, True), (15, False)])
def test_cli_on_a_mesh_matches_one_process(tmp_path, seq, divides):
    from repro_torch.launch.train import main

    one = main(ARGS + ["--seq", str(seq)])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", f"from tests.test_torch_train_cli_mesh "
         f"import _spawn; _spawn({seq}, {str(tmp_path)!r})"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    for r in range(2):
        out = dict(np.load(tmp_path / f"rank{r}.npz"))
        np.testing.assert_allclose(out["losses"], one.losses, rtol=TOL,
                                   atol=TOL)
        assert int(out["params"]) < one.params      # a shard of each
        assert (seq % 2 == 0) == divides
