"""The port's multi-process mesh (``parallel/multihost.py``) on the CPU.

Two gloo processes form a 1 x 2 table mesh (``global_mesh``): their
all-reduced shares equal dpf_tpu's scalar oracle, the int32 sum across
processes wraps mod 2^32 (the backend's own sum, and the 16-bit halves
the port falls to when a backend's does not wrap), and both ranks label
their flight events.  ``initialize``'s no-cluster, explicit-argument
and timeout paths follow dpf_tpu's ``multihost`` rules.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import dpf_tpu
from dpf_tpu.parallel import multihost as jmultihost
from dpf_tpu_torch.parallel import multihost
from dpf_tpu_torch.parallel.cluster_net import make_table
from dpf_tpu_torch.utils.compat import has_cpu_multiprocess
from dpf_tpu_torch.utils.hermetic import free_port, gloo_env

ROOT = Path(__file__).resolve().parent.parent

RANK_SCRIPT = r"""
import json, sys
import numpy as np, torch
from dpf_tpu_torch.obs.flight import FLIGHT
from dpf_tpu_torch.parallel import multihost, sharded
torch.set_num_threads(1)
assert multihost.initialize(initialization_timeout_s=60)
rank = multihost.process_info().index
mesh = multihost.global_mesh(n_table=2, device="cpu")
big = 2 ** 31 - 1
part = lambda idx, k: torch.full((2, 3), big, dtype=torch.int32) + rank
wraps = mesh.sum_wraps()
direct = sharded.mesh_sum(mesh, 2, 3, part).tolist()
mesh._wraps = False            # the 16-bit halves' reduction
halves = sharded.mesh_sum(mesh, 2, 3, part).tolist()
shares = multihost.run_rank(n=1024, entry_size=4, prf_method=2,
                            scheme="logn", radix=2, batch=4, seed=9,
                            device="cpu")
FLIGHT.record("probe")
out = {"rank": rank, "world": multihost.process_info().count,
       "wraps": wraps, "direct": direct, "halves": halves,
       "entries": len(mesh.local_entries()), "shares": shares.tolist(),
       "flight_process": FLIGHT.dump(last=1)[0].get("process")}
multihost.shutdown()
print("RESULT " + json.dumps(out))
"""


def _run_ranks(world=2):
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, **gloo_env(r, world, port),
             "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"})
        for r in range(world)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=180)
        assert p.returncode == 0, err[-3000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        outs.append(json.loads(line[-1][7:]))
    return sorted(outs, key=lambda o: o["rank"])


def test_two_process_gloo_mesh():
    assert has_cpu_multiprocess()
    r0, r1 = _run_ranks()
    assert (r0["world"], r1["world"]) == (2, 2)
    assert r0["entries"] == r1["entries"] == 1
    # rank r adds 2^31 - 1 + r: the sum wraps, whichever reduction
    want = np.array((2 * (2 ** 31 - 1) + 1) % (1 << 32),
                    np.uint32).view(np.int32)
    for r in (r0, r1):
        assert r["direct"] == r["halves"] == [[int(want)] * 3] * 2
    assert r0["wraps"] is True          # gloo's int32 sum wraps
    assert (r0["flight_process"], r1["flight_process"]) == (0, 1)
    # the shares equal dpf_tpu's oracle on the same keys and table
    keys = multihost.rank_keys(1024, 2, "logn", 2, 4, 9)[0]
    jd = dpf_tpu.DPF(prf=2)
    jd.eval_init(make_table(1024, 4, 9))
    want = np.asarray(jd.eval_cpu([k.numpy() for k in keys]))
    np.testing.assert_array_equal(np.array(r0["shares"], np.int32), want)
    np.testing.assert_array_equal(np.array(r1["shares"], np.int32), want)


@pytest.fixture
def _fresh(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "DPF_EXPECT_CLUSTER", "SLURM_NTASKS",
                "OMPI_COMM_WORLD_SIZE", "JAX_COORDINATOR_ADDRESS",
                "COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                "TPU_WORKER_HOSTNAMES"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(multihost, "_initialized", False)
    monkeypatch.setattr(multihost, "_init_error", None)
    yield


def test_no_cluster_returns_false_with_the_cause(_fresh):
    assert multihost.initialize() is False
    assert "no process group" in multihost.init_error()
    info = multihost.process_info()
    assert (info.index, info.count) == (0, 1)
    assert info.init_error == multihost.init_error()
    assert not multihost.is_initialized()


def test_cluster_expected_raises(_fresh, monkeypatch):
    monkeypatch.setenv("DPF_EXPECT_CLUSTER", "1")
    with pytest.raises(RuntimeError, match="no process group"):
        multihost.initialize()
    assert multihost.init_error()
    with pytest.raises(ValueError, match="together"):
        multihost.initialize("127.0.0.1:1", 2)


def test_cluster_expected_env_hints_match_dpf_tpu(_fresh, monkeypatch):
    """The hints both packages read give the same verdict."""
    for var, val in (("DPF_EXPECT_CLUSTER", "0"), ("DPF_EXPECT_CLUSTER",
                                                    "yes"),
                     ("SLURM_NTASKS", "4"), ("OMPI_COMM_WORLD_SIZE", "1"),
                     ("SLURM_NTASKS", "x")):
        monkeypatch.setenv(var, val)
        assert multihost._cluster_expected() == \
            jmultihost._cluster_expected(), (var, val)
        monkeypatch.delenv(var)
    monkeypatch.setenv("WORLD_SIZE", "2")      # torch's launcher hint
    assert multihost._cluster_expected()


def test_initialize_timeout_names_the_coordinator(_fresh):
    """Rank 1 of a group whose store never starts fails within its
    bound, and the cause says which coordinator did not answer."""
    addr = "127.0.0.1:%d" % free_port()
    with pytest.raises(Exception):
        multihost.initialize(addr, 2, 1, initialization_timeout_s=2,
                             backend="gloo")
    cause = multihost.init_error()
    assert cause and ("InitializationTimeout" in cause or addr in cause
                      or "timed out" in cause.lower()), cause


def test_default_backend_and_global_mesh_rules(_fresh, monkeypatch):
    assert multihost.default_backend(2, "cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert multihost.default_backend(2, "cuda") == "gloo"  # ranks share
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert multihost.default_backend(2, "cuda") == "nccl"
    with pytest.raises(RuntimeError, match="initialize"):
        multihost.global_mesh()
