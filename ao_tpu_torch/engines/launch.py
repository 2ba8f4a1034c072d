"""Launch (port of ao_tpu/engines/launch.py; reference: pointcept/engines/
launch.py:36-137): one process per card.

``launch(main_func, num_devices_per_machine, num_machines, machine_rank,
dist_url, cfg)`` runs ``main_func(*cfg)``:

* in this process, with no process group, when the world is one process
  (and returns what ``main_func`` returns);
* in this process, in the group a ``torchrun`` environment describes
  (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``), when there is
  one;
* otherwise in ``num_devices_per_machine`` processes started with the
  ``spawn`` method (CUDA cannot be forked), process ``i`` of machine
  ``machine_rank`` being rank ``machine_rank * num_devices_per_machine + i``
  of a group initialised at ``dist_url`` (``"auto"``: a free localhost port,
  one machine only).

The group's backend is NCCL for ``device="cuda"`` and gloo for the CPU
(``backend`` chooses otherwise: gloo also carries CUDA tensors' all_reduce
and broadcast). A rank on the card takes card ``local_rank`` of the
machine's cards, modulo their count under gloo; NCCL needs one card a
rank.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# a collective that waits longer than this fails instead of hanging
TIMEOUT = datetime.timedelta(minutes=30)


def free_port() -> int:
    """A free TCP port on localhost (for a group's ``tcp://`` address)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _torchrun_env() -> bool:
    return all(k in os.environ for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE",
                                         "MASTER_ADDR", "MASTER_PORT"))


def local_device(device: str = "cuda") -> torch.device:
    """This process's device: under a group, ``"cuda"`` means the card the
    launcher set for this rank."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and dist.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _init_group(rank, local_rank, world_size, dist_url, device, backend,
                num_local):
    backend = backend or ("nccl" if torch.device(device).type == "cuda"
                          else "gloo")
    if torch.device(device).type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("device cuda: no card is visible")
        if backend == "nccl" and num_local > cards:
            raise RuntimeError(
                f"NCCL needs one card a rank: {num_local} ranks on a machine "
                f"with {cards} card(s) (gloo runs several on one)")
        torch.cuda.set_device(local_rank % cards)
    dist.init_process_group(backend, init_method=dist_url,
                            world_size=world_size, rank=rank, timeout=TIMEOUT)


def distributed_worker(local_rank, main_func, world_size, num_devices_per_machine,
                       machine_rank, dist_url, cfg, device="cuda", backend=None):
    """One rank: set ``RANK`` / ``LOCAL_RANK`` / ``WORLD_SIZE``, pick the
    card, initialise the group, run ``main_func(*cfg)`` and destroy the
    group. Returns what ``main_func`` returns."""
    rank = machine_rank * num_devices_per_machine + local_rank
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(local_rank),
                      WORLD_SIZE=str(world_size))
    _init_group(rank, local_rank, world_size, dist_url, device, backend,
                num_devices_per_machine)
    try:
        dist.barrier()
        return main_func(*cfg)
    finally:
        dist.destroy_process_group()


def launch(main_func: Callable, num_devices_per_machine: Optional[int] = 1,
           num_machines: int = 1, machine_rank: int = 0,
           dist_url: Optional[str] = "auto", cfg=(), device: str = "cuda",
           backend: Optional[str] = None):
    """Run ``main_func(*cfg)`` on every rank (see the module docstring).
    Returns its result in a one-process world or a torchrun rank, None
    after spawning."""
    if _torchrun_env():
        world = int(os.environ["WORLD_SIZE"])
        local = int(os.environ["LOCAL_RANK"])
        _init_group(int(os.environ["RANK"]), local, world, "env://", device,
                    backend, int(os.environ.get("LOCAL_WORLD_SIZE", world)))
        try:
            return main_func(*cfg)
        finally:
            dist.destroy_process_group()
    num_local = num_devices_per_machine or 1
    world = num_local * num_machines
    if world == 1:
        return main_func(*cfg)
    if dist_url in (None, "auto"):
        if num_machines > 1:
            raise ValueError("dist_url='auto' serves one machine: give every "
                             "machine machine 0's tcp://<host>:<port>")
        dist_url = f"tcp://127.0.0.1:{free_port()}"
    mp.start_processes(
        distributed_worker, nprocs=num_local, join=True, start_method="spawn",
        args=(main_func, world, num_local, machine_rank, dist_url, cfg, device,
              backend))
    return None
