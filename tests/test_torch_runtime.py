"""The port's multi-process runtime (``gs_localization_torch.parallel.runtime``)
and its N-process dryrun, on the CPU.

Single-process pieces run in this process (no process group: a mesh of one
rank whose collectives are the identity); a gloo world of 2 ranks runs the
pieces that need one (the mesh's sub-groups, the per-rank slices and the
global batch's round trip); and the 2-process dryrun
(``python -m gs_localization_torch.parallel.dryrun``) runs at its tiny size
(about 10 s)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from gs_localization_torch.parallel import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_KEYS = ("GSLOC_COORDINATOR", "GSLOC_NUM_PROCESSES", "GSLOC_PROCESS_ID")


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ENV_KEYS + ("XLA_FLAGS",)}
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = REPO
    return env


def test_parallel_package_import_is_side_effect_free():
    """``import gs_localization_torch.parallel`` (and its submodules)
    creates no process group, does not initialise CUDA and imports no JAX
    (subprocess probe)."""
    code = (
        "import sys, torch\n"
        "import gs_localization_torch.parallel as p\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "assert hasattr(p, 'runtime') and callable(p.dp_train_grads)\n"
        "from gs_localization_torch.parallel import dryrun, tile_shard\n"
        "assert not dist.is_initialized()\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "print('clean')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "clean" in r.stdout, r.stderr[-2000:]


def test_initialize_runtime_single_process_noop(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    assert runtime.initialize_runtime() is False
    monkeypatch.setenv("GSLOC_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("GSLOC_NUM_PROCESSES", "1")
    assert runtime.initialize_runtime() is False
    monkeypatch.setenv("GSLOC_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="process index"):
        runtime.initialize_runtime()
    with pytest.raises(ValueError, match="backend"):
        runtime.initialize_runtime(process_id=0, backend="mpi")
    assert not torch.distributed.is_initialized()


def test_global_mesh_and_host_slice():
    mesh = runtime.global_mesh(("data",))
    assert mesh.shape == {"data": 1} and mesh.group("data") is None
    assert runtime.host_local_slice(16, mesh) == (0, 16)
    mesh2 = runtime.global_mesh(("data", "gauss"), (1, 1))
    assert runtime.host_local_slice(8, mesh2, axis="gauss") == (0, 8)
    with pytest.raises(ValueError, match="holds 2 ranks"):
        runtime.global_mesh(("data",), (2,))
    with pytest.raises(ValueError, match="not divisible"):
        runtime.host_local_slice(7, _FakeMesh(2))


class _FakeMesh:
    """A 2-rank axis as seen from rank 1, for the slice arithmetic."""

    def __init__(self, size):
        self.axis_names = ("data",)
        self.shape = {"data": size}

    def index(self, axis):
        return 1


def test_host_slice_of_a_later_rank():
    assert runtime.host_local_slice(8, _FakeMesh(2)) == (4, 8)


def test_make_global_batch_roundtrip():
    mesh = runtime.global_mesh(("data",))
    local = np.arange(12, dtype=np.float32).reshape(4, 3)
    arr = runtime.make_global_batch(local, mesh, device="cpu")
    assert isinstance(arr, torch.Tensor) and arr.device.type == "cpu"
    np.testing.assert_array_equal(arr.numpy(), local)
    tree = runtime.make_global_batch({"a": local, "b": [local[:, 0]]}, mesh,
                                     device="cpu")
    np.testing.assert_array_equal(tree["b"][0].numpy(), local[:, 0])
    with pytest.raises(ValueError, match="leading sizes"):
        runtime.make_global_batch({"a": local, "b": local[:2]}, mesh,
                                  device="cpu")
    np.testing.assert_array_equal(runtime.process_allgather(local),
                                  local[None])


_WORLD_CODE = r"""
import sys
import numpy as np
import torch
from gs_localization_torch.parallel import runtime
rank = int(sys.argv[1])
assert runtime.initialize_runtime(f"127.0.0.1:{sys.argv[2]}", 2, rank)
assert torch.distributed.get_backend() == "gloo"
mesh = runtime.global_mesh(("data", "gauss"), (1, 2))
assert mesh.index("gauss") == rank and mesh.index("data") == 0
lo, hi = runtime.host_local_slice(8, mesh, axis="gauss")
assert (lo, hi) == (4 * rank, 4 * rank + 4), (lo, hi)
glob = np.arange(24, dtype=np.float32).reshape(8, 3)
block = runtime.make_global_batch(glob[lo:hi], mesh, axis="gauss",
                                  device="cpu")
back = runtime.process_allgather(block.numpy()).reshape(8, 3)
assert np.array_equal(back, glob)
try:
    runtime.make_global_batch(glob[:3 + rank], mesh, axis="gauss",
                              device="cpu")
    raise SystemExit("uneven blocks accepted")
except ValueError:
    pass
s = runtime.all_reduce_sum(torch.tensor([1.0 + rank]), mesh.group("gauss"))
assert float(s) == 3.0
x = torch.full((2,), float(rank), requires_grad=True)
y = runtime.gather_rows(x, mesh, "gauss")
assert y.tolist() == [0.0, 0.0, 1.0, 1.0]
(y * torch.arange(4.0)).sum().backward()
assert x.grad.tolist() == ([0.0, 1.0] if rank == 0 else [2.0, 3.0])
torch.distributed.destroy_process_group()
print("world ok")
"""


def test_two_rank_world():
    """A gloo world of 2: the mesh's sub-groups and coordinates, the
    per-rank slices, make_global_batch's round trip through
    process_allgather and its check of uneven blocks, a summed all-reduce,
    and gather_rows' backward taking the rank's own rows."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, "-c", _WORLD_CODE, str(r),
                               str(port)], cwd=REPO, env=_env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "world ok" in out, out[-2000:]


def test_two_process_dryrun():
    """The multi-process controller path at the tiny size: 2 gloo ranks
    run the dryrun's checks (DP loss = the single-process loss within
    1e-5, all-gathered refined poses within 2 lr iters, final losses)."""
    r = subprocess.run(
        [sys.executable, "-m", "gs_localization_torch.parallel.dryrun",
         "--nproc", "2", "--device", "cpu"], cwd=REPO, env=_env(), capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    assert r.stdout.count("dryrun_multiprocess: p") == 2
    assert "ALL OK (2 processes, gloo, cpu)" in r.stdout
