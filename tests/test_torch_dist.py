"""The port's process-group start-up (``parallel/dist.py``), its
data-parallel layout (``parallel/mesh.py``), the rank shares of the
training loader and the meters' cross-process sums, on the CPU.

The launcher cases mirror ``tests/test_multiprocess.py`` (the JAX
package's), plus torchrun's. Real ranks are subprocesses on ``gloo`` with a
free port, each given torchrun's environment: :func:`run_ranks` starts them
(the other multi-rank test files import it). The children import the port
only, never jax.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest
import torch

from medicalsemseg_tpu.data.datalist import partition_dataset as jax_partition

from medicalsemseg_tpu_torch.config import Config, get_args
from medicalsemseg_tpu_torch.data.dataset import rank_share
from medicalsemseg_tpu_torch.parallel import dist as pdist
from medicalsemseg_tpu_torch.parallel.mesh import (
    data_parallel_size,
    shard_batch,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LAUNCH_ENVS = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                "WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT", "SLURM_NTASKS", "SLURM_PROCID",
                "SLURM_LOCALID", "OMPI_COMM_WORLD_SIZE",
                "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_LOCAL_RANK")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(code: str, world: int, tmp_path, timeout: int = 240,
              env=None, argv=()):
    """Run ``code`` as ``world`` ranks of one gloo job (torchrun's
    environment: RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT),
    each with two CPU threads, from the repository root; returns each
    rank's standard output. ``code`` finds the rank in ``RANK`` and the
    scratch directory in ``OUT``; a rank that fails fails the test."""
    script = tmp_path / f"rank_job_{free_port()}.py"
    script.write_text(textwrap.dedent(code))
    port = free_port()
    procs = []
    for r in range(world):
        e = {k: v for k, v in os.environ.items() if k not in _LAUNCH_ENVS}
        e.update(PYTHONPATH=REPO, OUT=str(tmp_path), RANK=str(r),
                 WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                 OMP_NUM_THREADS="2", PYTEST_XDIST_WORKER_COUNT="")
        e.update(env or {})
        procs.append(subprocess.Popen(
            [sys.executable, str(script), *argv], cwd=REPO, env=e,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode())
    finally:   # a rank that hangs must not outlive the test
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def torchrun(module: str, argv, nproc: int, timeout: int = 300) -> str:
    """``torchrun --nproc_per_node nproc -m module argv`` from the
    repository root, two CPU threads a rank; returns the output."""
    e = {k: v for k, v in os.environ.items() if k not in _LAUNCH_ENVS}
    e.update(PYTHONPATH=REPO, OMP_NUM_THREADS="2",
             PYTEST_XDIST_WORKER_COUNT="")
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         str(nproc), "--master_addr", "127.0.0.1", "--master_port",
         str(free_port()), "-m", module, *argv],
        cwd=REPO, env=e, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        timeout=timeout)
    out = p.stdout.decode()
    assert p.returncode == 0, out[-4000:]
    return out


@pytest.fixture
def no_launcher(monkeypatch):
    for k in _LAUNCH_ENVS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


@pytest.mark.parametrize("env,match", [
    ({"COORDINATOR_ADDRESS": "127.0.0.1:1234"}, "NUM_PROCESSES"),
    ({"WORLD_SIZE": "2"}, "RANK"),
    ({"WORLD_SIZE": "2", "RANK": "0"}, "MASTER_ADDR"),
    ({"SLURM_NTASKS": "4"}, "SLURM_PROCID"),
    ({"OMPI_COMM_WORLD_SIZE": "2", "OMPI_COMM_WORLD_RANK": "1"},
     "MASTER_ADDR"),
])
def test_detect_env_raises_on_partial_declaration(no_launcher, env, match):
    for k, v in env.items():
        no_launcher.setenv(k, v)
    with pytest.raises(ValueError, match=match):
        pdist.detect_env()


def test_detect_env_single_process_envs(no_launcher):
    assert pdist.detect_env() is None
    # single-task SLURM / MPI envs are not a multi-process launch
    no_launcher.setenv("SLURM_NTASKS", "1")
    no_launcher.setenv("OMPI_COMM_WORLD_SIZE", "1")
    assert pdist.detect_env() is None
    assert pdist.declared_world_size() == 1
    for k, v in (("SLURM_NTASKS", "4"), ("SLURM_PROCID", "2"),
                 ("SLURM_LOCALID", "1"), ("MASTER_ADDR", "10.0.0.1"),
                 ("MASTER_PORT", "29500")):
        no_launcher.setenv(k, v)
    assert pdist.detect_env() == {"world_size": 4, "rank": 2,
                                  "local_rank": 1,
                                  "init_method": "tcp://10.0.0.1:29500"}
    assert pdist.declared_world_size() == 4


def test_detect_env_torchrun_and_coordinator(no_launcher):
    for k, v in (("WORLD_SIZE", "8"), ("RANK", "5"), ("LOCAL_RANK", "1"),
                 ("MASTER_ADDR", "node0"), ("MASTER_PORT", "23456")):
        no_launcher.setenv(k, v)
    assert pdist.detect_env() == {"world_size": 8, "rank": 5,
                                  "local_rank": 1,
                                  "init_method": "tcp://node0:23456"}
    # the JAX package's variables come first
    for k, v in (("COORDINATOR_ADDRESS", "host:1234"),
                 ("NUM_PROCESSES", "2"), ("PROCESS_ID", "1")):
        no_launcher.setenv(k, v)
    assert pdist.detect_env() == {"world_size": 2, "rank": 1,
                                  "local_rank": 1,
                                  "init_method": "tcp://host:1234"}
    assert pdist.declared_world_size() == 2


def test_world_size_without_a_launcher_names_torchrun(no_launcher):
    cfg = get_args(["--world_size", "2", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2"):
        pdist.init_distributed_mode(cfg, torch.device("cpu"))
    # one process without a launcher: nothing is joined
    assert pdist.init_distributed_mode(Config(), torch.device("cpu")) == \
        torch.device("cpu")
    assert pdist.get_world_size() == 1 and pdist.is_main_process()


@pytest.mark.parametrize("batch,world,mesh,want", [
    (4, 2, None, 2), (4, 3, None, 2), (6, 4, None, 3), (1, 4, None, 1),
    (8, 8, None, 8), (4, 4, (2,), 2), (4, 4, 2, 2)])
def test_data_parallel_size(batch, world, mesh, want):
    """The largest divisor of the global batch that is at most the world
    size, as the JAX training CLI picks its mesh; ``mesh_shape`` (k,)
    sets k."""
    assert data_parallel_size(batch, world, mesh) == want


@pytest.mark.parametrize("mesh", [(2, 2), (3,), (8,)])
def test_mesh_shapes_that_do_not_fit_raise(mesh):
    with pytest.raises(ValueError, match="mesh_shape"):
        data_parallel_size(4, 4, mesh)


@pytest.mark.parametrize("n_images,patches,dp", [
    (2, 2, 2), (4, 1, 2), (1, 4, 2), (2, 2, 4), (6, 2, 4), (3, 2, 1)])
def test_rank_share_splits_the_global_batch(n_images, patches, dp):
    cfg = rank_share(Config(n_images_per_batch=n_images,
                            t_n_patches_per_image=patches), dp)
    assert cfg.n_images_per_batch * cfg.t_n_patches_per_image * dp == \
        n_images * patches
    assert cfg.n_images_per_batch * dp % n_images == 0


def test_shard_batch_takes_this_ranks_rows():
    batch = {"image": torch.arange(8).reshape(4, 2),
             "label": torch.arange(4)}
    parts = [shard_batch(batch, r, 2) for r in range(2)]
    assert torch.equal(torch.cat([p["image"] for p in parts]), batch["image"])
    assert parts[1]["label"].tolist() == [2, 3]
    with pytest.raises(ValueError, match="3 ranks"):
        shard_batch(batch, 0, 3)


_JOIN = """
    import json, os, torch
    from medicalsemseg_tpu_torch.config import Config
    from medicalsemseg_tpu_torch.data.datalist import partition_dataset
    from medicalsemseg_tpu_torch.parallel import dist as pdist
    from medicalsemseg_tpu_torch.parallel.mesh import create_mesh, replicated
    from medicalsemseg_tpu_torch.utils.logger import MetricLogger, SmoothedValue

    torch.set_num_threads(2)
    dev = pdist.init_distributed_mode(Config(world_size=2),
                                      torch.device("cpu"))
    rank = pdist.get_rank()
    out = {"rank": rank, "world": pdist.get_world_size(), "device": str(dev),
           "main": pdist.is_main_process()}
    files = [{"image": f"img{i}"} for i in range(9)]
    out["part"] = [f["image"] for f in
                   partition_dataset(files, 2, even_divisible=True)[rank]]
    # rank 0 logs [1, 2], rank 1 logs [3, 5]: the global average is 2.75
    logger = MetricLogger()
    logger.add_meter("loss", SmoothedValue(10))
    for v in ([1.0, 2.0] if rank == 0 else [3.0, 5.0]):
        logger.update(loss=v)
    logger.synchronize_between_processes()
    out["count"] = logger.meters["loss"].count
    out["avg"] = logger.meters["loss"].global_avg
    # a batch of 3 on 2 ranks: one trains, the other sits out, and both
    # end up with rank 0's weights
    mesh = create_mesh(3)
    out["dp"], out["trains"] = mesh.dp, mesh.trains
    lin = torch.nn.Linear(3, 2)
    torch.nn.init.constant_(lin.weight, float(rank))
    out["weight"] = replicated(lin).weight.sum().item()
    json.dump(out, open(os.path.join(os.environ["OUT"], f"r{rank}.json"), "w"))
    pdist.shutdown()
"""

_UNJOINED = """
    import os, torch, torch.distributed as dist
    from medicalsemseg_tpu_torch.config import Config
    from medicalsemseg_tpu_torch.parallel import dist as pdist

    # a world of one joined, then a launcher that declares two
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:"
                            + os.environ["MASTER_PORT"], world_size=1, rank=0)
    os.environ["WORLD_SIZE"] = "2"
    try:
        pdist.init_distributed_mode(Config(), torch.device("cpu"))
    except RuntimeError as e:
        print("RAISED", e)
    pdist.shutdown()
"""


def test_two_ranks_join_partition_and_sum_their_meters(tmp_path):
    """Two gloo ranks: rank and world, disjoint and covering partitions
    (equal to the JAX package's), the meters' sums after the fp64
    all_reduce, a layout with a rank that sits out, and the raise of a
    declared world that did not join."""
    run_ranks(_JOIN, 2, tmp_path)
    res = [json.load(open(tmp_path / f"r{r}.json")) for r in range(2)]
    files = [{"image": f"img{i}"} for i in range(9)]
    want = jax_partition(files, 2, even_divisible=True)
    for r, out in enumerate(res):
        assert out["rank"] == r and out["world"] == 2
        assert out["device"] == "cpu" and out["main"] == (r == 0)
        assert out["part"] == [f["image"] for f in want[r]]
        assert out["count"] == 4 and abs(out["avg"] - 2.75) < 1e-12
        assert out["dp"] == 1 and out["trains"] == (r == 0)
        assert out["weight"] == 0.0
    p0, p1 = set(res[0]["part"]), set(res[1]["part"])
    assert p0 | p1 == {f"img{i}" for i in range(9)}
    assert len(p0 & p1) == 1    # even_divisible pads by wrapping one file
    out = run_ranks(_UNJOINED, 1, tmp_path, env={"WORLD_SIZE": "1"})[0]
    assert "RAISED launcher declared 2 processes but 1 joined" in out
