"""Two-process sharded solve on ``torch.distributed`` (gloo on 127.0.0.1),
mirroring tests/test_distributed.py: each worker, which imports torch and
the port only, initializes the group, solves its
``process_local_batch_slice`` of one global batch over a mesh of two CPU
devices, checks its lanes against an unsharded solve of the same lanes
(x within 1e-10), and checks that the all-reduced ``BatchStats`` count
every lane of the global batch."""
import os
import socket
import subprocess
import sys

import pytest
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, sys
rank, world, coord, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
sys.path.insert(0, os.environ["JRLQP_REPO"])
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from jrlqp_tpu_torch.parallel import distributed, make_mesh, solve_sharded
from jrlqp_tpu_torch.solver.dense import solve_batch
from jrlqp_tpu_torch.testing.batch_gen import random_qp_batch

distributed.initialize(coord, num_processes=world, process_id=rank,
                       backend="gloo")
assert dist.get_world_size() == world and dist.get_rank() == rank

B, n, m = 16, 6, 10
# the same global batch in every process (one seed), of which each keeps
# its slice
gen = torch.Generator().manual_seed(0)
pbs = random_qp_batch(gen, B, n, m, act_frac=0.3, device="cpu")
sl = distributed.process_local_batch_slice(B)
local = pbs._map(lambda t: t[sl])
mesh = make_mesh(devices=[torch.device("cpu")] * 2)
res, stats = solve_sharded(local, mesh=mesh)
ref = solve_batch(local)
assert torch.equal(res.status, ref.status)
assert float((res.x - ref.x).abs().max()) <= 1e-10
assert local.batch == B // world, local.batch
assert stats.n_success == B, stats            # summed over both processes
full = solve_batch(pbs)
assert stats.max_iterations == int(full.iterations.max()), stats
assert stats.total_iterations == int(full.iterations.sum()), stats
dist.destroy_process_group()
with open(os.path.join(outdir, f"ok{rank}"), "w") as fh:
    fh.write(f"lanes={local.batch}")
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_sharded_solve(tmp_path):
    if not dist.is_available() or not dist.is_gloo_available():
        pytest.skip("torch.distributed has no gloo backend here")
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    env = dict(os.environ, JRLQP_REPO=REPO)
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, str(worker), str(i), "2",
                               coord, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"rank {i} rc={p.returncode}\n{outs[i][-3000:]}"
        assert (tmp_path / f"ok{i}").exists(), outs[i][-3000:]


def test_single_process_defaults():
    from jrlqp_tpu_torch.parallel import distributed

    assert not dist.is_initialized()
    distributed.initialize()                       # no group: a no-op
    distributed.initialize(num_processes=1)
    assert not dist.is_initialized()
    assert distributed.process_local_batch_slice(10) == slice(0, 10)
