"""Device meshes, collectives and rank start-up on ``torch.distributed``.

Port of :mod:`gpyrn_tpu.parallel.mesh`.  Two named axes cover the
parallelism this model family exposes:

* ``dp``: data parallel: MCMC walkers, multi-start restarts, evidence
  samples, and the row slabs of the matrix-free matvec;
* ``lat``: the (q × p) weight lattice of the dense engine, and the row
  slabs of the panel-sharded engine (the N axis).

JAX runs SPMD from one process over many devices (``shard_map``,
``lax.psum``, ``lax.all_gather``).  Here every rank is a process holding
its own shard, and a function that JAX calls once under ``shard_map`` is
called **collectively** by every rank of the mesh: each rank computes its
slab, the collectives below put the pieces together, and every rank ends
with the same (replicated) result.  Loops that JAX writes as
``lax.while_loop`` are host loops whose stopping test reads a replicated
value, so all ranks stop together.

=====================================  =====================================
JAX                                    here
=====================================  =====================================
``Mesh(devices, ("dp", "lat"))``       ``init_device_mesh`` (:func:`make_mesh`)
``lax.psum``                           :func:`all_reduce`
``lax.all_gather(tiled=True)``         :func:`all_gather`
``lax.axis_index``                     :attr:`Axis.rank`
``shard_along`` (``device_put``)       :func:`shard_along` / :func:`gather_along`
``jax.set_mesh``                       :func:`use_mesh` / :func:`current_mesh`
=====================================  =====================================

Ranks are started by ``torchrun`` for a user, or by :func:`spawn`, which
the tests and ``chip_smoke.py`` use: ``spawn`` start method (CUDA cannot
fork), a ``FileStore`` in a temporary directory (no network), a timeout
on every collective and on the whole job, so that a hang fails.  The
backend is the caller's choice and nothing switches it: ``gloo`` on the
CPU, ``nccl`` for one rank per card, and ``gloo`` on CUDA tensors to put
several ranks on one card.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import queue as _queue
import tempfile
import time
import traceback
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

DP_AXIS = "dp"
LAT_AXIS = "lat"

__all__ = ["DP_AXIS", "LAT_AXIS", "Axis", "make_mesh", "mesh_axis",
           "divides", "shard_along", "gather_along", "dp_rows", "use_mesh",
           "current_mesh",
           "all_gather", "all_reduce", "broadcast", "reduce_grad",
           "gather_grad", "spawn"]


def make_mesh(n_devices: Optional[int] = None,
              shape: Optional[Tuple[int, int]] = None,
              device_type: str = "cuda"):
    """The 2-D ``(dp, lat)`` device mesh over the ranks of the default
    process group.  With ``shape`` unset every rank is on ``dp`` and
    ``lat`` has size 1 (the JAX package's default).  The mesh must cover
    the world: a shape or ``n_devices`` that does not raises."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world if shape is None else shape[0] * shape[1]
    if shape is None:
        shape = (n_devices, 1)
    if shape[0] * shape[1] != n_devices or n_devices != world:
        raise ValueError(f"mesh shape {tuple(shape)} != {world} ranks")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=(DP_AXIS, LAT_AXIS))


class Axis(NamedTuple):
    """One mesh axis as this rank sees it: its process group, the rank's
    index along it, its size, and the group's backend."""
    group: object
    rank: int
    size: int
    backend: str


def mesh_axis(mesh, axis_name: str) -> Axis:
    group = mesh.get_group(axis_name)
    return Axis(group, dist.get_rank(group), dist.get_world_size(group),
                str(dist.get_backend(group)))


_MESHES: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the current mesh (:func:`current_mesh`) inside the
    block: the lattice-sharded engine reads it, as the JAX package's
    engine reads the mesh of ``jax.set_mesh``."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def current_mesh():
    """The innermost mesh of :func:`use_mesh`, or None."""
    return _MESHES[-1] if _MESHES else None


# ---- collectives -----------------------------------------------------------

def all_gather(x: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """The pieces ``x`` of every rank of ``axis`` joined along ``dim`` in
    rank order (``lax.all_gather(tiled=True)``).  NCCL gathers into one
    tensor; gloo, which lacks that on CUDA tensors, takes the list form.
    A boolean tensor travels as bytes."""
    if x.dtype == torch.bool:
        return all_gather(x.to(torch.uint8), axis, dim).bool()
    x = x.contiguous()
    if axis.backend == "nccl":
        out = x.new_empty((axis.size, *x.shape))
        dist.all_gather_into_tensor(out, x, group=axis.group)
        parts = out.unbind(0)
    else:
        parts = [torch.empty_like(x) for _ in range(axis.size)]
        dist.all_gather(parts, x, group=axis.group)
    return torch.cat(parts, dim=dim)


def all_reduce(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis`` (``lax.psum``), out of
    place."""
    out = x.clone()
    dist.all_reduce(out, group=axis.group)
    return out


class _ReduceGrad(torch.autograd.Function):
    """Identity forward; the gradient summed over the ranks of the axis."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.axis), None


class _GatherGrad(torch.autograd.Function):
    """:func:`all_gather` forward; this rank's piece of the gradient."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.axis.rank * ctx.n, ctx.n), None, None


def reduce_grad(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x`` itself, whose gradient is summed over the ranks of ``axis``:
    the input of work that each rank does on its own share, so that the
    gradient of a replicated input collects every share's part."""
    return _ReduceGrad.apply(x, axis)


def gather_grad(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """:func:`all_gather` under autograd: the output is replicated, so the
    gradient of this rank's piece is its own slice of the (replicated)
    output gradient."""
    return _GatherGrad.apply(x, axis, dim)


def broadcast(x: torch.Tensor, owner: int, axis: Axis) -> torch.Tensor:
    """``x`` of the rank ``owner`` (its index along ``axis``) on every
    rank, in place; the other ranks pass a buffer of the same shape."""
    dist.broadcast(x, src=dist.get_global_rank(axis.group, owner),
                   group=axis.group)
    return x


def divides(n: int, mesh, axis_name: str = DP_AXIS) -> bool:
    """Whether ``n`` rows split evenly over the ranks of the mesh axis."""
    return n % mesh_axis(mesh, axis_name).size == 0


def shard_along(x, mesh, axis_name: str = DP_AXIS, dim: int = 0):
    """This rank's contiguous share of ``x`` along ``dim`` over the mesh
    axis; the length there must divide by the axis size."""
    ax = mesh_axis(mesh, axis_name)
    n = x.shape[dim]
    if n % ax.size:
        raise ValueError(f"dimension {dim} of length {n} does not divide "
                         f"over the {ax.size} ranks of '{axis_name}'")
    n //= ax.size
    return x.narrow(dim, ax.rank * n, n)


def gather_along(x, mesh, axis_name: str = DP_AXIS, dim: int = 0):
    """The shares of :func:`shard_along` joined again, on every rank."""
    return all_gather(x, mesh_axis(mesh, axis_name), dim)


def dp_rows(fn, mesh, *rows, axis_name: str = DP_AXIS):
    """``fn(*rows)`` for tensors ``rows`` with a common leading length:
    with a mesh and a length that divides by the axis size, each rank runs
    ``fn`` on its share of every row tensor and every output (a tensor or
    a tuple of them, rows first) is gathered again on every rank;
    otherwise ``fn`` runs on all the rows (on every rank of a mesh)."""
    if mesh is None or not divides(rows[0].shape[0], mesh, axis_name):
        return fn(*rows)
    out = fn(*(shard_along(r, mesh, axis_name) for r in rows))
    if isinstance(out, torch.Tensor):
        return gather_along(out, mesh, axis_name)
    return tuple(gather_along(o, mesh, axis_name) for o in out)


# ---- rank start-up -----------------------------------------------------------

def _worker(rank, fn, world_size, backend, device_type, store_path, args,
            results, timeout):
    # the ranks of one host: their sockets stay on the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout))
        results.put((rank, True, fn(*args)))
    except BaseException:                     # reported to the parent
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world_size: int, backend: str, device_type: str, *args,
          timeout: float = 600.0):
    """Run ``fn(*args)`` in ``world_size`` fresh processes joined in one
    process group (``backend``; each CUDA rank on card ``rank % count``)
    and return the ranks' results in rank order.  ``fn`` and its results
    must pickle.  A rank that raises, or a job that outlasts ``timeout``
    seconds, ends every rank and raises here."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_worker, daemon=True,
                             args=(r, fn, world_size, backend, device_type,
                                   store, args, results, timeout))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        out, got = [None] * world_size, set()
        deadline = time.monotonic() + timeout
        grace = None
        try:
            while len(got) < world_size:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except _queue.Empty:
                    # a rank that ended without a result (it died before
                    # its function ran) fails the job at once; a result
                    # still in the pipe gets a few seconds to arrive
                    now = time.monotonic()
                    gone = [r for r, p in enumerate(procs)
                            if p.exitcode is not None and r not in got]
                    if gone and grace is not None and now > grace:
                        raise RuntimeError(
                            f"spawn: rank {gone[0]} ended with exit code "
                            f"{procs[gone[0]].exitcode} and no result")
                    if gone and grace is None:
                        grace = now + 5.0
                    if now > deadline:
                        raise TimeoutError(f"spawn: ranks still running "
                                           f"after {timeout} s") from None
                    continue
                if not ok:
                    raise RuntimeError(f"spawn: rank {rank} failed:\n{value}")
                out[rank] = value
                got.add(rank)
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(5.0)
    return out
