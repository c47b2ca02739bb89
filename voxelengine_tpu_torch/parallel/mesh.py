"""A one-axis device mesh over ``torch.distributed``, its collectives, and
the launcher that runs a function on N ranks.

Counterpart of ``jax.sharding.Mesh`` and of the collectives ``shard_map``
gives its body.  Each rank is one process and every rank calls the same
function (SPMD); a ``psum`` is :func:`psum` (``all_reduce(SUM)``), a
``pmin``/``pmax`` :func:`pmin`/:func:`pmax`, a neighbour ``ppermute``
:func:`ppermute_neighbours` (a ``batch_isend_irecv`` pair), and a rank with
no neighbour on a side receives zeros, as in JAX.  Bools travel as int32.

Transport: under NCCL, CUDA tensors go to the collectives as they are.
Gloo has no point-to-point or gather for CUDA tensors, so under gloo a CUDA
tensor is staged through host memory for every collective (counted in
``Mesh.staged_bytes``); that is how N ranks share one card.  The kernels
still run on the card: staging moves only the collectives' operands.

:func:`run_ranks` spawns the ranks (``torch.multiprocessing``, spawn start
method: CUDA cannot be re-initialised in a forked child), each with a
``FileStore`` in a temporary directory (no port to collide on) and one
torch thread, and returns each rank's result; a rank that raises makes it
raise, with that rank's traceback.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import tempfile
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from voxelengine_tpu_torch.config import default_device


@dataclasses.dataclass
class Mesh:
    """One rank's view of a one-axis mesh: the process group (``None``: the
    default group), this rank, the number of ranks, the axis name and the
    device this rank's tensors live on."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    axis: str
    device: torch.device
    staged_bytes: int = 0  # bytes copied to and from host memory for gloo

    @property
    def staged(self) -> bool:
        """Whether CUDA tensors go through host memory (gloo)."""
        return self.device.type == "cuda" and dist.get_backend(self.group) == "gloo"


def make_mesh(group=None, device=None, axis: str = "rows") -> Mesh:
    """This rank's :class:`Mesh` over ``group`` (the default process group
    when ``None``); ``device`` defaults to :func:`config.default_device`."""
    dev = torch.device(default_device() if device is None else device)
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group), axis, dev)


def _to_wire(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` as a collective takes it: bools as int32, CUDA tensors in host
    memory under gloo.  Always a fresh tensor (collectives work in place)."""
    if x.dtype == torch.bool:
        x = x.to(torch.int32)
    if mesh.staged:
        mesh.staged_bytes += x.numel() * x.element_size()
        return x.to("cpu")
    return x.clone()


def _from_wire(w: torch.Tensor, like: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Undo :func:`_to_wire` for a tensor shaped and typed as ``like``."""
    if mesh.staged:
        mesh.staged_bytes += w.numel() * w.element_size()
        w = w.to(like.device)
    return w > 0 if like.dtype == torch.bool else w


def _all_reduce(x: torch.Tensor, mesh: Mesh, op) -> torch.Tensor:
    w = _to_wire(x, mesh)
    dist.all_reduce(w, op=op, group=mesh.group)
    return _from_wire(w, x, mesh)


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum of ``x`` over the ranks (``jax.lax.psum``); for bools, whether
    any rank's is set."""
    return _all_reduce(x, mesh, dist.ReduceOp.SUM)


def pmin(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Elementwise minimum over the ranks (``jax.lax.pmin``)."""
    return _all_reduce(x, mesh, dist.ReduceOp.MIN)


def pmax(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Elementwise maximum over the ranks (``jax.lax.pmax``)."""
    return _all_reduce(x, mesh, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all ranks), concatenated along the
    first axis in rank order."""
    w = _to_wire(x, mesh)
    parts = [torch.empty_like(w) for _ in range(mesh.size)]
    dist.all_gather(parts, w, group=mesh.group)
    return _from_wire(torch.cat(parts), x, mesh)


def ppermute_neighbours(up: torch.Tensor, down: torch.Tensor, mesh: Mesh, recv_shapes=None):
    """Send ``up`` to rank + 1 and ``down`` to rank - 1 (the two neighbour
    ``ppermute``s of JAX's ``[(i, i + 1)]`` and ``[(i + 1, i)]``); returns
    ``(from_below, from_above)``: what rank - 1 sent up and what rank + 1
    sent down, zeros where there is no such rank.  ``recv_shapes`` gives
    their shapes where they differ from ``up``'s and ``down``'s (a
    variable-sized payload whose size the neighbour announced first); an
    empty payload is neither sent nor received."""
    shapes = recv_shapes or (up.shape, down.shape)
    below = torch.zeros(shapes[0], dtype=up.dtype, device=up.device)
    above = torch.zeros(shapes[1], dtype=down.dtype, device=down.device)
    r, n = mesh.rank, mesh.size
    sends, recvs = [], []
    if r + 1 < n:
        sends.append((up, r + 1))
        recvs.append((above, r + 1))
    if r > 0:
        sends.append((down, r - 1))
        recvs.append((below, r - 1))
    def global_rank(peer):
        return peer if mesh.group is None else dist.get_global_rank(mesh.group, peer)

    ops, wires = [], []
    for t, peer in sends:
        if t.numel():
            ops.append(dist.P2POp(dist.isend, _to_wire(t, mesh), global_rank(peer), mesh.group))
    for t, peer in recvs:
        if t.numel():
            w = torch.empty(t.shape, dtype=torch.int32 if t.dtype == torch.bool else t.dtype,
                            device="cpu" if mesh.staged else t.device)
            wires.append((t, w))
            ops.append(dist.P2POp(dist.irecv, w, global_rank(peer), mesh.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for t, w in wires:
        t.copy_(_from_wire(w, t, mesh))
    return below, above


# ---------------------------------------------------------------------------
# the launcher


def _rank_main(rank: int, n: int, backend: str, device: str, workdir: str, timeout_s: float, fn, args):
    """One rank: join the group through the file store, run ``fn(mesh,
    *args)``, save its result (or the traceback) for the caller."""
    torch.set_num_threads(1)
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        store = dist.FileStore(os.path.join(workdir, "store"), n)
        # NCCL is told the rank's card rather than left to guess it from the rank
        kw = dict(device_id=dev) if backend == "nccl" else {}
        dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                                timeout=datetime.timedelta(seconds=timeout_s), **kw)
        try:
            out = fn(make_mesh(device=dev), *args)
            torch.save(out, os.path.join(workdir, f"rank{rank}.tmp"))
            os.replace(os.path.join(workdir, f"rank{rank}.tmp"), os.path.join(workdir, f"rank{rank}.pt"))
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn, n: int, backend: str = "gloo", device=None, *args, timeout: float = 900.0, workdir=None):
    """Run ``fn(mesh, *args)`` on ``n`` ranks, one process each, and return
    their results in rank order.

    ``fn`` must be importable by a fresh process (a module-level function);
    its result is saved with ``torch.save`` and loaded here onto the CPU.
    ``device`` is where each rank's tensors live: ``"cuda"`` (the default,
    :func:`~voxelengine_tpu_torch.config.default_device`; rank r on card
    ``r % torch.cuda.device_count()``; under gloo N ranks share one card,
    under NCCL each needs its own) or ``"cpu"``.  If a rank raises or
    dies, the others are stopped and this raises with its traceback; after
    ``timeout`` seconds every rank is stopped and this raises.  Scratch
    (the file store, the results) goes to a temporary directory under
    ``workdir`` (default: the system's), removed at the end.
    """
    if backend == "nccl" and n > torch.cuda.device_count():
        raise ValueError(f"run_ranks: NCCL needs a card a rank, {n} ranks on {torch.cuda.device_count()} cards")
    import torch.multiprocessing as mp

    device = default_device() if device is None else device
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ranks_", dir=workdir)
    procs = []
    try:
        for r in range(n):
            p = ctx.Process(target=_rank_main, args=(r, n, backend, str(device), tmp, timeout, fn, args))
            p.start()
            procs.append(p)
        deadline = time.monotonic() + timeout
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
        if failed or any(p.is_alive() for p in procs):
            # a rank that fails takes its peers' collectives down with it:
            # give them a moment to record their own errors, then stop them
            grace = time.monotonic() + 5.0
            while failed and any(p.is_alive() for p in procs) and time.monotonic() < grace:
                time.sleep(0.05)
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join()
            errs = []
            for r, p in enumerate(procs):
                path = os.path.join(tmp, f"rank{r}.err")
                if os.path.exists(path):
                    errs.append(f"rank {r} of {n}:\n{open(path).read()}")
                elif r in failed:
                    errs.append(f"rank {r} of {n}: exit code {p.exitcode}\n")
            raise RuntimeError("run_ranks: " + ("".join(errs) if errs else f"timed out after {timeout:.0f} s"))
        for p in procs:
            p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), map_location="cpu", weights_only=False)
                for r in range(n)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
