"""Process-group start-up (counterpart of medicalsemseg_tpu/parallel/dist.py).

The port runs one process per GPU: a launch on N cards is
``torchrun --nproc_per_node N -m medicalsemseg_tpu_torch.cli.<entry> ...``.
:func:`detect_env` reads the launcher's environment (torchrun's, and the
JAX package's COORDINATOR_ADDRESS / SLURM / Open MPI ones),
:func:`init_distributed_mode` joins ``torch.distributed`` (NCCL on CUDA,
gloo on the CPU; ``MEDSEG_DIST_BACKEND`` names another, as ``gloo`` for
ranks that share one card, which NCCL refuses) and pins rank r to
``cuda:LOCAL_RANK``. Without a launcher
nothing is joined and the entry points use one device.

A launcher that declares more processes than join is an error, never a
silent single-process run on a share of the data.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
import torch.distributed as dist


def _require(keys, what: str) -> None:
    missing = [k for k in keys if k not in os.environ]
    if missing:
        raise ValueError(f"{what} set but {missing} missing; a declared "
                         "multi-process launch must be fully specified")


def _address(what: str) -> str:
    _require(("MASTER_ADDR", "MASTER_PORT"), what)
    return f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"


def detect_env() -> Optional[Dict]:
    """The launch the environment declares, or None when it declares none.

    Returns {'world_size', 'rank', 'local_rank', 'init_method'}. Read in
    this order: the JAX package's ``COORDINATOR_ADDRESS`` (host:port) with
    ``NUM_PROCESSES`` and ``PROCESS_ID``; torchrun's ``WORLD_SIZE`` /
    ``RANK`` / ``LOCAL_RANK`` with ``MASTER_ADDR`` / ``MASTER_PORT``;
    ``SLURM_NTASKS`` > 1 with ``SLURM_PROCID`` / ``SLURM_LOCALID``;
    ``OMPI_COMM_WORLD_SIZE`` > 1 with ``OMPI_COMM_WORLD_RANK`` /
    ``OMPI_COMM_WORLD_LOCAL_RANK`` (these two take their address from
    ``MASTER_ADDR`` / ``MASTER_PORT``). A partial declaration raises
    ValueError."""
    env = os.environ
    local = int(env.get("LOCAL_RANK", 0))
    if "COORDINATOR_ADDRESS" in env:
        _require(("NUM_PROCESSES", "PROCESS_ID"), "COORDINATOR_ADDRESS")
        return {"world_size": int(env["NUM_PROCESSES"]),
                "rank": int(env["PROCESS_ID"]), "local_rank": local,
                "init_method": f"tcp://{env['COORDINATOR_ADDRESS']}"}
    if "WORLD_SIZE" in env:
        _require(("RANK",), "WORLD_SIZE")
        return {"world_size": int(env["WORLD_SIZE"]), "rank": int(env["RANK"]),
                "local_rank": local, "init_method": _address("WORLD_SIZE")}
    if int(env.get("SLURM_NTASKS", "1")) > 1:
        _require(("SLURM_PROCID",), "SLURM_NTASKS")
        return {"world_size": int(env["SLURM_NTASKS"]),
                "rank": int(env["SLURM_PROCID"]),
                "local_rank": int(env.get("SLURM_LOCALID", local)),
                "init_method": _address("SLURM_NTASKS")}
    if int(env.get("OMPI_COMM_WORLD_SIZE", "1")) > 1:
        _require(("OMPI_COMM_WORLD_RANK",), "OMPI_COMM_WORLD_SIZE")
        return {"world_size": int(env["OMPI_COMM_WORLD_SIZE"]),
                "rank": int(env["OMPI_COMM_WORLD_RANK"]),
                "local_rank": int(env.get("OMPI_COMM_WORLD_LOCAL_RANK",
                                          local)),
                "init_method": _address("OMPI_COMM_WORLD_SIZE")}
    return None


def declared_world_size() -> int:
    for k in ("NUM_PROCESSES", "WORLD_SIZE", "SLURM_NTASKS",
              "OMPI_COMM_WORLD_SIZE"):
        if k in os.environ:
            return int(os.environ[k])
    return 1


def init_distributed_mode(cfg, device: torch.device) -> torch.device:
    """Join the process group that the launcher declares and return this
    rank's device: ``cuda:LOCAL_RANK`` for a CUDA ``device``, the CPU
    otherwise. Without a launcher, returns ``device`` unchanged; then
    ``--world_size`` > 1 raises, since one process cannot be N. A declared
    world that is not the world that joined raises, and so does a
    ``--world_size`` > 1 that disagrees with it."""
    env = detect_env()
    if env is None:
        if cfg.world_size > 1:
            raise RuntimeError(
                f"--world_size {cfg.world_size} without a launcher: the port "
                "runs one process per GPU, start it with torchrun "
                f"--nproc_per_node {cfg.world_size} -m "
                "medicalsemseg_tpu_torch.cli.<entry point> ...")
        return device
    if cfg.world_size > 1 and cfg.world_size != env["world_size"]:
        raise RuntimeError(
            f"--world_size {cfg.world_size} but the launcher declared "
            f"{env['world_size']} processes (torchrun --nproc_per_node sets "
            "the world)")
    if device.type == "cuda":
        device = torch.device("cuda", env["local_rank"])
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            os.environ.get("MEDSEG_DIST_BACKEND")
            or ("nccl" if device.type == "cuda" else "gloo"),
            init_method=env["init_method"], world_size=env["world_size"],
            rank=env["rank"])
    if dist.get_world_size() != declared_world_size():
        raise RuntimeError(
            f"launcher declared {declared_world_size()} processes but "
            f"{dist.get_world_size()} joined; refusing to continue on "
            "partial data")
    print(f"distributed: process {get_rank()} of {get_world_size()} on "
          f"{device}")
    return device


def is_dist() -> bool:
    return dist.is_available() and dist.is_initialized()


def is_main_process() -> bool:
    return get_rank() == 0


def get_rank() -> int:
    return dist.get_rank() if is_dist() else 0


def get_world_size() -> int:
    return dist.get_world_size() if is_dist() else 1


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if is_dist():
        dist.destroy_process_group()
