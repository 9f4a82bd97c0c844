"""Multi-process runtime: process bring-up, meshes of process groups,
per-rank data.

One rank owns one device (PyTorch's model), so the JAX package's
``cpu_devices_per_process`` has no counterpart: a CPU dryrun of N devices
is N gloo processes. Every rank runs the same program:

    from gs_localization_torch.parallel import runtime
    runtime.initialize_runtime()          # env-driven; no-op single-process
    mesh = runtime.global_mesh(("data",))
    lo, hi = runtime.host_local_slice(n_queries, mesh)
    local = load_queries(lo, hi)          # each rank touches only its block
    batch = runtime.make_global_batch(local, mesh, "data", device)
    res = shard_queries_refine(mesh, gaussians, *batch)   # every rank: all
    errs = runtime.process_allgather(local_errs)          # host-side merge
    runtime.shutdown_runtime()            # every rank, before it exits

Environment (read when the arguments are None, the launcher's pattern):
  GSLOC_COORDINATOR   "host:port" of rank 0 (a ``tcp://`` address; rank 0
                      binds that port), or a ``file://`` address that
                      every rank can open (``local_rendezvous`` for ranks
                      on one host)
  GSLOC_NUM_PROCESSES world size
  GSLOC_PROCESS_ID    this rank

Ranks on one host meet through a fresh store file
(``local_rendezvous(tmpdir)``), never through a port picked ahead of
time: a port that is found free and let go can be taken by any other
process before rank 0 binds it.

Backends are explicit and never switched on failure: ``nccl`` for ranks
that each own a card, ``gloo`` on the CPU, and ``gloo`` for ranks that
share one card (NCCL refuses two ranks on one device), which the caller
asks for with ``backend="gloo"``. gloo moves CUDA tensors only for
broadcast and all-reduce, so the collectives here stage a CUDA tensor
through host memory under gloo.
"""

from __future__ import annotations

import datetime
import os
import uuid
import weakref
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

_TIMEOUT = datetime.timedelta(minutes=10)
_MESHES = weakref.WeakSet()     # the live meshes, whose groups shutdown drops


def initialize_runtime(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> bool:
    """Join this process to the world's process group (idempotent).

    Returns True when running multi-process, False for a single process
    (no environment, no arguments, or a world of 1: every test and the
    one-card CLI), which creates no group. ``backend`` defaults to
    ``nccl`` when CUDA is available and ``gloo`` otherwise; ranks that
    share one card pass ``"gloo"``. Under ``nccl`` each rank takes card
    ``rank % device_count`` as its current device."""
    coordinator_address = coordinator_address or os.environ.get(
        "GSLOC_COORDINATOR")
    if num_processes is None and "GSLOC_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["GSLOC_NUM_PROCESSES"])
    if process_id is None and "GSLOC_PROCESS_ID" in os.environ:
        process_id = int(os.environ["GSLOC_PROCESS_ID"])

    if coordinator_address is None or num_processes is None or \
            int(num_processes) <= 1:
        return False
    if process_id is None:
        raise ValueError(
            "multi-process bring-up needs a process index: pass "
            "process_id= or set GSLOC_PROCESS_ID")
    if dist.is_initialized():
        return True
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl":
        torch.cuda.set_device(int(process_id) % torch.cuda.device_count())
    address = coordinator_address
    if not address.startswith(("tcp://", "file://")):
        address = f"tcp://{address}"
    dist.init_process_group(backend, init_method=address,
                            world_size=int(num_processes),
                            rank=int(process_id), timeout=_TIMEOUT)
    return True


def local_rendezvous(tmpdir) -> str:
    """A ``file://`` address for one world whose ranks share this host's
    file system: a store file of a fresh name in the existing directory
    ``tmpdir``. The ranks meet in the file, so no port is chosen before
    the process that binds it runs. Each world needs its own address (a
    store file left from an earlier world would hang the next one)."""
    path = os.path.join(os.path.abspath(tmpdir),
                        f"rendezvous-{uuid.uuid4().hex}")
    return f"file://{path}"


def shutdown_runtime() -> None:
    """Leave the world (a no-op without a process group): drop the process
    groups of every live ``Mesh``, whose ``group`` then raises, and destroy
    all groups. A group still referenced after ``destroy_process_group``
    keeps gloo's worker threads running until the interpreter exits, and
    a worker that then drops the last reference to a tensor needs the GIL
    of an interpreter that is gone: the process aborts after its work is
    done. Dropped here, the groups join their threads at once."""
    if not dist.is_initialized():
        return
    for mesh in list(_MESHES):
        mesh._groups = None
    dist.destroy_process_group()


def rank_device(device="cuda") -> torch.device:
    """This rank's device, the package's policy: ``device`` (default the
    card) as ``gs_localization_torch.resolve_device`` takes it, raising when
    it names CUDA and there is none. The card is the current one: under
    ``nccl`` the rank's own (``initialize_runtime`` sets it), under ``gloo``
    the one every rank shares. Pass ``"cpu"`` for the plain versions."""
    from .. import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """The world's ranks laid out rank-major on named axes, with this
    rank's sub-group of each axis: the ranks that differ from it in that
    axis's coordinate only, in coordinate order (a group's rank is the
    axis coordinate). ``shape`` and ``axis_names`` read as the JAX mesh's.
    Without a process group the mesh is one rank and its collectives are
    the identity."""

    def __init__(self, axis_names: Sequence[str], axis_sizes: Sequence[int]):
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              map(int, axis_sizes)))
        world = dist.get_world_size() if dist.is_initialized() else 1
        rank = dist.get_rank() if dist.is_initialized() else 0
        size = int(np.prod(axis_sizes))
        if size != world:
            raise ValueError(f"mesh {dict(self.shape)} holds {size} ranks, "
                             f"the world has {world}")
        self.ranks = np.arange(world).reshape(tuple(self.shape.values()))
        coords = np.unravel_index(rank, self.ranks.shape)
        self.coords = dict(zip(self.axis_names, map(int, coords)))
        self._groups = {}
        for i, name in enumerate(self.axis_names):
            if not dist.is_initialized():
                self._groups[name] = None
                continue
            lines = np.moveaxis(self.ranks, i, -1).reshape(
                -1, self.ranks.shape[i])
            mine = None
            for line in lines:      # every rank creates every group, in order
                members = [int(r) for r in line]
                group = (dist.group.WORLD if len(members) == world
                         else dist.new_group(members))
                if rank in members:
                    mine = group
            self._groups[name] = mine
        if dist.is_initialized():
            _MESHES.add(self)

    def group(self, axis: str):
        """This rank's process group along ``axis`` (None: one rank)."""
        if self._groups is None:
            raise RuntimeError("this mesh's world was shut down")
        return self._groups[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
        return self.coords[axis]


def global_mesh(axis_names: Sequence[str] = ("data",),
                axis_sizes: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over every rank of the world, rank-major. ``axis_sizes``
    defaults to every rank on the first axis; their product must be the
    world size."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if axis_sizes is None:
        axis_sizes = (world,) + (1,) * (len(axis_names) - 1)
    return Mesh(axis_names, axis_sizes)


def host_local_slice(n_items: int, mesh: Mesh, axis: Optional[str] = None
                     ) -> Tuple[int, int]:
    """[lo, hi) of the global batch this rank loads: each rank owns a
    contiguous block of ``n_items / size`` along ``axis`` (default: the
    mesh's first axis)."""
    axis = axis or mesh.axis_names[0]
    size = mesh.shape[axis]
    if n_items % size:
        raise ValueError(
            f"batch {n_items} not divisible by mesh axis '{axis}' = {size}: "
            "pad the batch (pipelines pad with a repeated query)")
    block = n_items // size
    lo = mesh.index(axis) * block
    return lo, lo + block


def make_global_batch(local, mesh: Mesh, axis: str = "data",
                      device="cuda"):
    """This rank's block of a batch sharded over ``axis``, on its device
    (``rank_device``: the card unless ``device="cpu"``):
    tensors and arrays of a (nested) tuple, list or dict, leading dimension
    the block. PyTorch has no global array: the per-rank functions take
    their own block, and the global batch exists only as the blocks. The
    blocks' leading sizes are checked equal over the axis (one all-gather
    of the sizes)."""
    dev = rank_device(device)
    sizes = []

    def one(x):
        t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                            else x).to(dev)
        sizes.append(int(t.shape[0]))
        return t

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        return one(x)

    out = walk(local)
    if len(set(sizes)) > 1:
        raise ValueError(f"the block's leaves have leading sizes {sizes}")
    n = torch.tensor([sizes[0] if sizes else 0], dtype=torch.int64,
                     device=dev)
    all_n = all_gather_cat(n, mesh.group(axis))
    if len(set(all_n.tolist())) > 1:
        raise ValueError(f"uneven blocks along '{axis}': {all_n.tolist()}")
    return out


def process_allgather(x) -> np.ndarray:
    """Host-side gather of per-process numpy data (metrics merge): the
    world's values stacked on a new leading axis, in rank order."""
    a = np.asarray(x)
    if not dist.is_initialized():
        return a[None]
    t = torch.as_tensor(a)
    if dist.get_backend() == "nccl":
        t = t.cuda()
    return all_gather_cat(t[None], dist.group.WORLD).cpu().numpy()


# ---------------------------------------------------------------------------
# collectives on one axis's group
# ---------------------------------------------------------------------------

def _staged(t: torch.Tensor, group) -> bool:
    """gloo takes CUDA tensors only for broadcast and all-reduce: under
    gloo every collective here stages a CUDA tensor through host memory,
    one rule for all of them."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the group, a new tensor (``psum``)."""
    if group is None:
        return t.clone()
    x = t.detach().cpu() if _staged(t, group) else t.detach().clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x.to(t.device)


def all_gather_cat(t: torch.Tensor, group) -> torch.Tensor:
    """The group's tensors concatenated along dim 0 in group-rank order
    (``all_gather(tiled=True)``); bool tensors travel as uint8."""
    if group is None:
        return t.clone()
    x = t.detach().contiguous()
    is_bool = x.dtype == torch.bool
    if is_bool:
        x = x.to(torch.uint8)
    if _staged(t, group):
        x = x.cpu()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts, dim=0).to(t.device)
    return out.to(torch.bool) if is_bool else out


def axis_mean(ts: Sequence[torch.Tensor], mesh: Mesh, axis: str):
    """(first, rest): the mean of each tensor over the axis group, in one
    all-reduce of them all (a sum divided by the axis size: gloo has no
    average). ``pmean`` of a loss and its gradients."""
    flat = torch.cat([t.reshape(-1) for t in ts])
    flat = all_reduce_sum(flat, mesh.group(axis)) / mesh.shape[axis]
    out, at = [], 0
    for t in ts:
        out.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out[0], out[1:]


# ---------------------------------------------------------------------------
# differentiable collectives for a loss that every rank computes in full
# ---------------------------------------------------------------------------

class _GatherRows(torch.autograd.Function):
    """all_gather_cat forward; the backward takes this rank's rows of the
    cotangent. Every rank computes the same (replicated) loss, so each
    rank's cotangent of the gathered tensor is already the whole one:
    ``torch.distributed.nn``'s all-gather would sum the ranks' cotangents
    and scale the gradient by the group's size."""

    @staticmethod
    def forward(ctx, t, group, index):
        ctx.rows = (index * t.shape[0], (index + 1) * t.shape[0])
        return all_gather_cat(t, group)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.rows
        return g[lo:hi], None, None


def gather_rows(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The axis group's ``t`` concatenated along dim 0 (every rank holds as
    many rows), differentiable for a replicated loss: the gradient of this
    rank's ``t`` is its own rows of the gathered gradient."""
    return _GatherRows.apply(t, mesh.group(axis), mesh.index(axis))


class _SumGrads(torch.autograd.Function):
    """Identity forward; the backward sums each gradient over the group
    (one all-reduce of them all): the adjoint of a replicated input whose
    uses are split over the ranks (JAX's psum in the VJP of a replicated
    ``shard_map`` input)."""

    @staticmethod
    def forward(ctx, group, *ts):
        ctx.group = group
        ctx.shapes = [(t.shape, t.dtype, t.device) for t in ts]
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        flat = torch.cat([
            (g if g is not None else torch.zeros(s, dtype=d, device=dev))
            .reshape(-1) for g, (s, d, dev) in zip(gs, ctx.shapes)])
        flat = all_reduce_sum(flat, ctx.group)
        out, at = [], 0
        for s, _, _ in ctx.shapes:
            n = int(np.prod(s))
            out.append(flat[at:at + n].reshape(s))
            at += n
        return (None, *out)


def sum_grads(ts: Sequence[torch.Tensor], mesh: Mesh, axis: str):
    """``ts`` unchanged, with each gradient summed over the axis group in
    the backward."""
    return _SumGrads.apply(mesh.group(axis), *ts)
