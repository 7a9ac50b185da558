"""The row mesh of a sharded solve, on ``torch.distributed`` (port of
``lobpcg_tpu/parallel/mesh.py``).

The JAX package places the tall blocks, X and the operator data on a 1-D
device mesh over the rows and lets XLA's partitioner insert the
collectives.  PyTorch has no partitioner, so the port is explicit SPMD:
one process per rank (one card per rank: NCCL on CUDA, gloo on the CPU),
every rank running the same host loop on its own row block.  Every
reduction over rows is one ``all_reduce`` of the group (``ops/rows.py``);
the k x k work is replicated, and since every rank gets bit-identical
reduced values, every rank takes the same host decisions.  Operators
that mix rows exchange them explicitly (``halo_exchange``,
``permute_rows``, ``all_gather_rows``).

``row_mesh`` returns a ``RowMesh`` over the current process group (it
starts a world-size-1 group itself when there is none); ``spawn`` runs a
function on a group of local processes, the counterpart of the JAX
package's 8-device virtual CPU mesh.  There is no CPU fallback: the
default device is the CUDA card, and ``device="cpu"`` selects gloo.

Each collective counts its calls in ``.launches``, as the kernel
wrappers count theirs; a call that has no peer to talk to (a halo at
world size 1) issues nothing and counts nothing, while ``all_reduce``
runs at world size 1 too.

The exchanges move rows, the axis -2 of a block: an [n_loc, k] block,
or a lockstep batch [b, n_loc, k] (one problem's rows after another),
whose exchange is one call for the whole batch.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import tempfile
import time
from typing import Optional

import torch
import torch.distributed as dist

from lobpcg_tpu_torch.ops.rows import rows_ctx

ROWS = "rows"

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclasses.dataclass(eq=False)
class RowMesh:
    """A 1-D row partition over a process group: ``size`` ranks, this
    process is ``rank`` and computes on ``device``.  ``group`` None is
    the default group.  Entering the mesh (``with mesh:``) makes it the
    row group of the solves inside."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    axis: str = ROWS
    _entered: list = dataclasses.field(default_factory=list, repr=False)

    def global_rank(self, r: int) -> int:
        """The default group's rank of this group's rank ``r``."""
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return all_reduce(self, t, op)

    def __enter__(self):
        ctx = rows_ctx(self)
        ctx.__enter__()
        self._entered.append(ctx)
        return self

    def __exit__(self, *exc):
        return self._entered.pop().__exit__(*exc)


def all_reduce(mesh: RowMesh, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """A new tensor: ``t`` reduced (``"sum"`` or ``"max"``) over the
    ranks; every rank gets the same bits."""
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=_REDUCE_OPS[op], group=mesh.group)
    all_reduce.launches += 1
    return out


def _p2p(mesh: RowMesh, sends, recvs) -> None:
    """Post the (tensor, peer) sends and receives as one batch and wait."""
    ops = [dist.P2POp(dist.isend, t.contiguous(), mesh.global_rank(p), mesh.group)
           for t, p in sends]
    ops += [dist.P2POp(dist.irecv, t, mesh.global_rank(p), mesh.group)
            for t, p in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _with_rows(X: torch.Tensor, rows: int) -> tuple:
    """X's shape with ``rows`` rows (axis -2)."""
    return tuple(X.shape[:-2]) + (rows, X.shape[-1])


def halo_exchange(mesh: RowMesh, X: torch.Tensor, h: int):
    """(halo_up, halo_dn): the last ``h`` rows of rank - 1 and the first
    ``h`` rows of rank + 1, [..., h, k] each (each problem's of a batch);
    zeros at the ends of the chain, as ``ppermute`` gives them.  One
    batch of sends and receives."""
    r, nd = mesh.rank, mesh.size
    halo_up = torch.zeros(_with_rows(X, h), dtype=X.dtype, device=X.device)
    halo_dn = torch.zeros_like(halo_up)
    sends, recvs = [], []
    if r > 0:
        sends.append((X[..., :h, :], r - 1))
        recvs.append((halo_up, r - 1))
    if r + 1 < nd:
        sends.append((X[..., -h:, :], r + 1))
        recvs.append((halo_dn, r + 1))
    if sends:
        _p2p(mesh, sends, recvs)
        halo_exchange.launches += 1
    return halo_up, halo_dn


@dataclasses.dataclass(frozen=True)
class RowPlan:
    """One rank's part of a global row permutation Y[i] = X[src(i)]:
    ``sends`` (peer, local row ranges it needs, in its order), ``recvs``
    (peer, rows it sends) and ``parts`` (source, lo, hi) in this rank's
    output order, the source -1 for the local rows, else a peer's
    buffer."""

    sends: tuple
    recvs: tuple
    parts: tuple


def row_plan(n: int, nd: int, rank: int, pieces) -> RowPlan:
    """The exchange of a piecewise shift over ``nd`` ranks of n / nd rows
    each, for rank ``rank``, worked out on the host.  ``pieces``: the
    (out_lo, out_hi, src_lo) global row ranges that cover [0, n), where
    Y[out_lo + t] = X[src_lo + t]."""
    n_loc = n // nd

    def runs(r):
        """(source rank, src_lo, src_hi) of rank r's output rows, in order."""
        o0, o1 = r * n_loc, (r + 1) * n_loc
        out = []
        for lo, hi, src in sorted(pieces):
            a, b = max(lo, o0), min(hi, o1)
            s, e = src + a - lo, src + b - lo
            while s < e:
                q = s // n_loc
                out.append((q, s, min(e, (q + 1) * n_loc)))
                s = out[-1][2]
        return out

    base = rank * n_loc
    recvs, parts = {}, []
    for q, s, e in runs(rank):
        if q == rank:
            parts.append((-1, s - base, e - base))
        else:
            off = recvs.get(q, 0)
            parts.append((q, off, off + e - s))
            recvs[q] = off + e - s
    sends = {}
    for r in range(nd):
        for q, s, e in runs(r) if r != rank else ():
            if q == rank:
                sends.setdefault(r, []).append((s - base, e - base))
    return RowPlan(sends=tuple((r, tuple(v)) for r, v in sends.items()),
                   recvs=tuple(recvs.items()), parts=tuple(parts))


def _rows(X: torch.Tensor, ranges) -> torch.Tensor:
    """X's rows over ``ranges`` ((lo, hi) pairs): a view for one range."""
    if len(ranges) == 1:
        (a, b), = ranges
        return X[..., a:b, :]
    return torch.cat([X[..., a:b, :] for a, b in ranges], dim=-2)


def permute_rows(mesh: RowMesh, X: torch.Tensor, plan: RowPlan) -> torch.Tensor:
    """This rank's rows of the permuted global block (``row_plan``): one
    batch of sends and receives, one message per peer.  A peer that
    needs one range gets a view of X, and an output of one part is that
    part itself, so a swap with a single partner copies nothing."""
    bufs = {q: torch.empty(_with_rows(X, rows), dtype=X.dtype,
                           device=X.device) for q, rows in plan.recvs}
    sends = [(_rows(X, ranges), q) for q, ranges in plan.sends]
    if sends or bufs:
        _p2p(mesh, sends, [(buf, q) for q, buf in bufs.items()])
        permute_rows.launches += 1
    parts = [(X if q < 0 else bufs[q])[..., a:b, :] for q, a, b in plan.parts]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)


def all_gather_rows(mesh: RowMesh, X: torch.Tensor) -> torch.Tensor:
    """The global block: every rank's rows, in rank order (each
    problem's of a batch)."""
    parts = [torch.empty_like(X, memory_format=torch.contiguous_format)
             for _ in range(mesh.size)]
    dist.all_gather(parts, X.contiguous(), group=mesh.group)
    all_gather_rows.launches += 1
    return torch.cat(parts, dim=-2)


all_reduce.launches = 0
halo_exchange.launches = 0
permute_rows.launches = 0
all_gather_rows.launches = 0


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def row_mesh(n_devices: Optional[int] = None, *, device=None,
             group=None) -> RowMesh:
    """The row mesh over ``group`` (default: the default process group).

    ``device``: the CUDA card (default; NCCL) or ``"cpu"`` (gloo).
    Raises without a card, with fewer cards than ranks, or when
    ``n_devices`` is not the group's size.  With no process group yet and
    ``n_devices`` None or 1, starts a world-size-1 group on an in-process
    store; a larger mesh needs one process per rank (``spawn``, or a
    launcher that calls ``init_process_group``).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"row_mesh: unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "row_mesh: no CUDA device; the mesh runs on the card by "
            "default (device='cpu' selects gloo on the CPU)")
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise RuntimeError(
                f"row_mesh({n_devices}): no process group; start one process "
                "per rank (lobpcg_tpu_torch.parallel.spawn, or a launcher "
                "that calls torch.distributed.init_process_group)")
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group(_backend_for(dev), store=dist.HashStore(),
                                 rank=0, world_size=1)
    size = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"row_mesh({n_devices}): the process group has "
                         f"{size} ranks")
    backend = str(dist.get_backend(group))
    if _backend_for(dev) not in backend:
        raise ValueError(f"row_mesh: a {backend} group cannot run on {dev}")
    if dev.type == "cuda":
        if dev.index is None:
            if torch.cuda.device_count() < size:
                raise RuntimeError(
                    f"row_mesh: {size} ranks need {size} cards, "
                    f"{torch.cuda.device_count()} visible (one NCCL "
                    "communicator cannot hold two ranks on one card)")
            dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    return RowMesh(group=group, rank=rank, size=size, device=dev)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a global tensor lives on a mesh: its rows split over the
    ranks (``rows``) or whole on every rank (replicated)."""

    mesh: RowMesh
    rows: bool

    def local(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's part of the global tensor ``x``, on its device; the
        rows are dimension ``dim`` (-2 for a batch [b, n, k], -1 for a
        batched diagonal [b, n])."""
        if self.rows:
            n_loc = x.shape[dim] // self.mesh.size
            x = x.narrow(dim, self.mesh.rank * n_loc, n_loc)
        return x.to(self.mesh.device)


def row_sharding(mesh: RowMesh, ndim: int, axis: str = ROWS) -> Placement:
    """Dim 0 partitioned over the mesh."""
    if ndim < 1 or axis != mesh.axis:
        raise ValueError(f"row_sharding: ndim {ndim}, axis {axis!r} on a "
                         f"mesh over {mesh.axis!r}")
    return Placement(mesh, rows=True)


def replicated(mesh: RowMesh) -> Placement:
    return Placement(mesh, rows=False)


def _spawn_worker(rank, world, device, timeout_s, tmp):
    with open(os.path.join(tmp, "call.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank)
    else:  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(
        _backend_for(dev), init_method=f"file://{tmp}/store",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(row_mesh(world, device=dev.type), *args)
        with open(os.path.join(tmp, f"result{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args, device=None, timeout_s: float = 120.0):
    """Run ``fn(mesh, *args)`` on ``world`` new processes, one rank each,
    and return their results (picklable) in rank order.

    ``device``: the CUDA cards (default; rank r takes card r, NCCL), or
    ``"cpu"`` (gloo).  Raises with fewer cards than ranks, as
    ``row_mesh`` does.  The group meets on a ``file://`` store in a
    temporary directory and its collectives time out after
    ``timeout_s``; the processes are joined with the same deadline,
    killed past it, and a ``TimeoutError`` raised, so a deadlocked
    collective fails in bounded time.  ``fn`` must be importable by name
    (a module-level function).
    """
    device = torch.device("cuda" if device is None else device).type
    if device == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(
            f"spawn: {world} ranks need {world} cards, "
            f"{torch.cuda.device_count()} visible (device='cpu' selects gloo)")
    with tempfile.TemporaryDirectory() as tmp:
        # The call goes through a file: handing large arguments to
        # torch.multiprocessing.spawn itself is far slower.
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        ctx = torch.multiprocessing.spawn(
            _spawn_worker, args=(world, device, timeout_s, tmp),
            nprocs=world, join=False)
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"spawn: {world} ranks of {fn.__name__} did not "
                        f"finish in {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(10)
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"result{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
