"""CPU meshes and process groups for tests and rehearsals (port of
``dpf_tpu/utils/hermetic.py``).

The JAX package forces a virtual multi-device CPU platform before its
backend starts.  PyTorch needs no such step: a mesh names its devices,
and one device may repeat, so ``force_cpu_mesh(n)`` is a list of ``n``
CPU devices for ``parallel.sharded.make_mesh``.  A child process joins a
gloo process group through the environment ``gloo_env`` builds
(``torch.distributed``'s ``env://`` rendezvous on a localhost port).
"""

from __future__ import annotations

import socket

import torch


def force_cpu_mesh(n_devices: int = 8) -> list:
    """``n_devices`` CPU devices for a test mesh."""
    if n_devices < 1:
        raise ValueError("a mesh needs at least one device (got %d)"
                         % n_devices)
    return [torch.device("cpu")] * n_devices


def free_port() -> int:
    """A free localhost TCP port (for a process group's rendezvous)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def gloo_env(rank: int, world_size: int, port: int,
             addr: str = "127.0.0.1") -> dict:
    """The ``env://`` rendezvous variables of one rank of a process group
    on this machine."""
    return {"MASTER_ADDR": addr, "MASTER_PORT": str(int(port)),
            "WORLD_SIZE": str(int(world_size)), "RANK": str(int(rank))}
