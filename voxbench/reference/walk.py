"""A flat voxel walk over the terrain rule, in plain torch.

Amanatides and Woo's DDA over unit voxels from each ray's origin until the
first solid voxel of :func:`voxbench.reference.terrain.solid` or the world's
edge, with the upstream's tie-break (x if strictly smallest, else y if
``ty <= tx && ty < tz``, else z; ``VolumeRaytracer.cu:293-313``).  It keeps
no brickmap: the world is the rule, evaluated at the voxels the rays pass.
The hit is the first solid voxel along the ray, which the upstream's
two-level walk also finds; where the two differ is rounding at voxel edges,
and the step budget: the two-level walk charges one step a voxel inside an
occupied chunk and one an empty chunk, so a ray that reaches ``max_steps``
ends there as a miss, which this walk, given no budget, never does.  A
budget here (AO's 8) counts the voxels tested after the start voxel, which
the two-level walk matches inside one chunk and exceeds across chunks.

A block of ``b`` steps is taken at once: the next ``b`` plane crossings of
each axis (``tmax + k * tdelta``), merged by a stable sort in which, on
equal ``t``, z comes before y before x (the tie-break above), then the
block's voxels are tested together.  Float math is in ``dtype`` (float64
for the reference; the control takes a lower one); cells are int64.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from voxbench.reference.terrain import solid_blocks

CELLS_PER_BLOCK = 1 << 20  # voxels tested together: a block's steps times its rays


class Walk(NamedTuple):
    hit: torch.Tensor  # bool[R]
    cell: torch.Tensor  # int64[R, 3], the hit voxel
    position: torch.Tensor  # [R, 3], where the ray entered it (the origin for a hit at the start)
    normal: torch.Tensor  # [R, 3], the stepped axis with the step's sign (0 for a hit at the start)


def _inside(cells: torch.Tensor, dims: torch.Tensor) -> torch.Tensor:
    return ((cells >= 0) & (cells < dims)).all(dim=-1)


def walk(origins: torch.Tensor, dirs: torch.Tensor, dims, octaves: int, max_steps: Optional[int] = None,
         dtype=torch.float64, max_iters: int = 40000) -> Walk:
    """First solid voxel along each ray of ``origins``, ``dirs`` (``[R, 3]``;
    directions normalised here) inside the world ``[0, dims)``.  Origins
    must lie inside the world.  ``max_steps`` bounds the voxels tested
    after the start voxel; ``max_iters`` bounds the steps of a ray that
    never ends (a control at too low a precision)."""
    dev = origins.device
    o = origins.to(dtype)
    d = dirs.to(dtype)
    d = d / torch.sqrt((d * d).sum(dim=-1, keepdim=True))
    n = o.shape[0]
    dims_t = torch.tensor(dims, dtype=torch.int64, device=dev)
    cell0 = torch.floor(o).to(torch.int64)
    step = torch.where(d > 0, 1, -1).to(torch.int64)
    inf = torch.full((), float("inf"), dtype=dtype, device=dev)
    safe = torch.where(d != 0, d, 1.0)
    tdelta = torch.where(d != 0, torch.abs(1.0 / safe), inf)
    tmax0 = torch.where(d != 0, ((cell0 + (step > 0)).to(dtype) - o) / safe, inf)
    taken = torch.zeros((n, 3), dtype=torch.int64, device=dev)  # steps taken along each axis

    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    hcell = cell0.clone()
    hpos = o.clone()
    hnrm = torch.zeros_like(o)
    inside0 = _inside(cell0, dims_t)
    s0 = torch.zeros(n, dtype=torch.bool, device=dev)
    if inside0.any():
        s0[inside0] = solid_blocks(cell0[inside0], octaves)
    hit |= s0
    budget = max_iters if max_steps is None else min(max_steps - 1, max_iters)
    done = 0
    idx = torch.nonzero(inside0 & ~s0).squeeze(1)
    order = torch.tensor([2, 1, 0], device=dev)  # z, y, x: the tie-break's order on equal t
    while idx.numel() and done < budget:
        r = idx.numel()
        b = max(min(CELLS_PER_BLOCK // r, budget - done, 4096), 1)
        k = torch.arange(b, device=dev, dtype=dtype)
        td = tdelta[idx][:, order, None]
        t_axes = torch.where(torch.isinf(td), inf,
                             tmax0[idx][:, order, None] + (taken[idx][:, order, None].to(dtype) + k) * td)
        t_all, pick = torch.sort(t_axes.reshape(r, 3 * b), dim=1, stable=True)
        t_b, axis_b = t_all[:, :b], order[pick[:, :b] // b]  # [r, b]: each step's t and axis
        onehot = torch.nn.functional.one_hot(axis_b, 3)
        counts = taken[idx][:, None, :] + torch.cumsum(onehot, dim=1)  # steps along each axis after each step
        cells_b = cell0[idx][:, None, :] + counts * step[idx][:, None, :]
        done += b
        ins = _inside(cells_b, dims_t)
        sol = torch.zeros_like(ins)
        sol[ins] = solid_blocks(cells_b[ins], octaves)
        # a ray that leaves the world ends there: nothing after it counts
        left = ~ins
        first_left = torch.where(left.any(dim=1), left.to(torch.int8).argmax(dim=1), b)
        first_sol = torch.where(sol.any(dim=1), sol.to(torch.int8).argmax(dim=1), b)
        got = first_sol < first_left
        g = torch.nonzero(got).squeeze(1)
        if g.numel():
            j = first_sol[g]
            gi = idx[g]
            hc = cells_b[g, j]
            ax = torch.nn.functional.one_hot(axis_b[g, j], 3).bool()
            sgn = step[gi]
            boundary = (hc + (sgn < 0)).to(dtype)  # the face the ray crossed into the hit voxel
            p = o[gi] + t_b[g, j][:, None] * d[gi]
            hit[gi] = True
            hcell[gi] = hc
            hpos[gi] = torch.where(ax, boundary, p)
            hnrm[gi] = torch.where(ax, sgn.to(dtype), 0.0)
        taken[idx] = counts[:, -1]
        idx = idx[~got & (first_left == b)]
    return Walk(hit, hcell, hpos, hnrm)
