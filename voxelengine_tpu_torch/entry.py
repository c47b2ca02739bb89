"""Entry points: one frame on the card, and a dry run of every
multi-device path on N ranks.

Counterpart of the JAX package's ``__graft_entry__.py``:

    python -m voxelengine_tpu_torch.entry                  # on the card
    python -m voxelengine_tpu_torch.entry --device cpu     # plain walks on the CPU

runs :func:`entry`'s frame once, then :func:`dryrun_multichip` on one
rank, and prints ``ok``.
"""

from __future__ import annotations

import argparse

import torch

from voxelengine_tpu_torch.config import default_device

ORIGIN = (128.0, 200.0, 128.0)
EULER = (-0.5, 0.6, 0.0)


def _make_world(device=None):
    """A small deterministic brickmap world: the terrain rule at a stride of
    8 voxels on a 64^3 grid, factor 8, LINEAR coarse layout (so that it can
    be z-sharded too)."""
    from voxelengine_tpu_torch.core.bitgrid import BitGrid
    from voxelengine_tpu_torch.core.brickmap import build_brickmap
    from voxelengine_tpu_torch.core.layout import Layout
    from voxelengine_tpu_torch.worldgen.terrain import solid_at

    dev = torch.device(default_device() if device is None else device)
    n = 64
    x = torch.arange(n, device=dev)[None, None, :]
    y = torch.arange(n, device=dev)[None, :, None]
    z = torch.arange(n, device=dev)[:, None, None]
    dense = solid_at(x * 8, y * 8, z * 8, octaves=4)  # [z, y, x]; the stride makes it vary
    return build_brickmap(BitGrid.from_dense(dense), 8, coarse_layout=Layout.LINEAR)


def entry(device=None):
    """``(fn, example_args)``: ``fn(bm, fb, origin, euler, frame_number)``
    renders one shaded 128x64 checkerboard frame of the 64^3 world through
    its line table (K1 on the card) into ``fb``, in place."""
    from voxelengine_tpu_torch.config import Environment, RenderConfig
    from voxelengine_tpu_torch.ops.bigtrace import make_line_table
    from voxelengine_tpu_torch.render.frame import make_framebuffer, render_frame

    dev = torch.device(default_device() if device is None else device)
    bm = _make_world(dev)
    lt = make_line_table(bm)
    cfg = RenderConfig(width=128, height=64, checkerboard=True)
    env = Environment.default(dev)

    def fn(bm, fb, origin, euler, frame_number):
        return render_frame(bm, fb, origin, euler, env, frame_number, cfg, lt=lt)

    example_args = (
        bm, make_framebuffer(cfg, dev), torch.tensor(ORIGIN, device=dev), torch.tensor(EULER, device=dev), 0,
    )
    return fn, example_args


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _dryrun_rank(mesh):
    """One rank of :func:`dryrun_multichip`; returns the shapes it checked."""
    from voxelengine_tpu_torch.config import Environment, RenderConfig
    from voxelengine_tpu_torch.ops.bigtrace import make_line_table
    from voxelengine_tpu_torch.parallel.distributed import (
        make_zsharded_hbm,
        render_frame_zsharded,
        trace_brickmap_hbm_zsharded,
        trace_brickmap_zsharded,
    )
    from voxelengine_tpu_torch.parallel.sharded import (
        cyclic_to_image,
        gather_rows,
        make_framebuffer_cyclic,
        make_framebuffer_rows,
        raytrace_sharded,
        render_frame_cyclic,
        render_frame_sharded,
    )
    from voxelengine_tpu_torch.render.frame import make_framebuffer

    n, dev = mesh.size, mesh.device
    bm = _make_world(dev)
    lt = make_line_table(bm)
    env = Environment.default(dev)
    origin, euler = torch.tensor(ORIGIN, device=dev), torch.tensor(EULER, device=dev)
    seen = {}

    # row bands through K1, the production layout
    cfg = RenderConfig(width=64, height=8 * n, checkerboard=True, tile_order=True)
    fb = render_frame_sharded(bm, make_framebuffer_rows(cfg, mesh), origin, euler, env, 0, cfg, mesh, lt)
    seen["rows"] = tuple(gather_rows(fb, mesh).shape)
    _check(seen["rows"] == (cfg.height, cfg.width, 3), f"row-band frame of shape {seen['rows']}")

    # block-cyclic pixel sharding, without a line table
    ccfg = RenderConfig(width=32 * n, height=16, checkerboard=True)
    cfb = render_frame_cyclic(bm, make_framebuffer_cyclic(ccfg, mesh), origin, euler, env, 0, ccfg, mesh)
    seen["cyclic"] = cyclic_to_image(gather_rows(cfb, mesh), ccfg).shape
    _check(seen["cyclic"] == (ccfg.height, ccfg.width, 3), f"cyclic frame of shape {seen['cyclic']}")

    # the batch query and its mean
    n_rays = 16 * n
    origins = torch.full((n_rays, 3), 100.0, device=dev)
    rays = torch.tensor([[0.3, -1.0, 0.2]], device=dev).expand(n_rays, 3).contiguous()
    out, mean = raytrace_sharded(bm, origins, rays, mesh)
    _check(out.hit.shape == (n_rays // n,) and bool(torch.isfinite(mean)), "raytrace_sharded's shard or mean")
    seen["mean_steps"] = float(mean)

    if bm.grid_dims[2] % n == 0:
        # the z-sharded world: migration, then K1's replicated walk
        zout = trace_brickmap_zsharded(bm, origins, rays, mesh)
        zw = make_zsharded_hbm(bm, n, mesh.rank)
        zhout = trace_brickmap_hbm_zsharded(zw, origins, rays, mesh)
        _check(torch.equal(zhout.hit, zout.hit), "the replicated walk's hits differ from the migration's")
        seen["zsharded_hits"] = int(zout.hit.sum())
        # the z-sharded frame, secondary rays through the same tracer
        zcfg = RenderConfig(width=32, height=16, checkerboard=False, shadow_rays=True, ao_samples=1,
                            reflections=True)
        zfb = render_frame_zsharded(bm, make_framebuffer(zcfg, dev), origin, euler, env, 0, zcfg, mesh, zw=zw)
        _check(bool(torch.isfinite(zfb).all()), "the z-sharded frame is not finite")
        seen["zsharded_frame"] = tuple(zfb.shape)
    return seen


def dryrun_multichip(n_devices: int, device=None):
    """Run every multi-device entry once on ``n_devices`` ranks
    (:func:`~voxelengine_tpu_torch.parallel.mesh.run_ranks`): the row-band
    frame through K1, the cyclic frame, ``raytrace_sharded`` with its mean,
    the migration trace and K1's replicated walk (whose hits must equal
    the migration's) and the z-sharded frame with shadows, AO 1 and
    reflections.  The ranks share the card over gloo (``device`` defaults
    to :func:`~voxelengine_tpu_torch.config.default_device`); ``device=
    "cpu"`` runs them on the CPU.  Returns each rank's record; raises if a rank fails."""
    from voxelengine_tpu_torch.parallel.mesh import run_ranks

    return run_ranks(_dryrun_rank, n_devices, "gloo", device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=str(default_device()), help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    fn, example_args = entry(args.device)
    fb = fn(*example_args)
    _check(bool(torch.isfinite(fb).all()), "entry()'s frame is not finite")
    dryrun_multichip(1, args.device)
    print("ok")


if __name__ == "__main__":
    main()
