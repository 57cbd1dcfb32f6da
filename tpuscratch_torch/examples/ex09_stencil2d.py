"""The flagship: 2D stencil with periodic halo exchange — stencil2d parity.

The twin of ``examples/ex09_stencil2d.py``. Mirrors the reference drivers
(stencil2d/mpi-2d-stencil-subarray{.cpp,-cuda.cu}): a periodic process
grid, per-rank tiles with ghost borders initialized to the rank id (halo =
-1), one exchange, and per-rank dumps named by grid coordinates; then
several real 5-point iterations, checked against the undecomposed-grid
oracle. The 2x4 mesh is stacked on the device; ``--impl=pallas`` (or
``blocked``, ``deep-pallas:k``, ...) runs the hand-written kernels.
"""

import os
import pathlib
import shutil
import tempfile

from tpuscratch_torch.examples._common import banner, ensure_devices


def main(argv=None, device=None, outdir=None) -> None:
    """``outdir``: where the per-rank dumps go (default a new temporary
    directory, removed again under pytest)."""
    device = ensure_devices(device=device)
    import numpy as np
    import torch

    from tpuscratch_torch.comm import P, run_spmd
    from tpuscratch_torch.halo import HaloSpec, TileLayout, halo_exchange
    from tpuscratch_torch.halo.driver import distributed_stencil
    from tpuscratch_torch.runtime.config import Config
    from tpuscratch_torch.runtime.log import coord_filename
    from tpuscratch_torch.runtime.mesh import make_mesh_2d, topology_of

    # argv tier, the reference driver's CLI (-cuda.cu:131-138):
    #   ex09_stencil2d [tile_w tile_h [stencil_w stencil_h]]
    #                  [--steps=N] [--impl=xla|pallas|blocked|...]
    cfg = Config.load(argv)
    tile_h = cfg.tile_height if "tile_height" in cfg.explicit else 8
    tile_w = cfg.tile_width if "tile_width" in cfg.explicit else 8
    banner("stencil2d halo exchange (flagship)")
    mesh = make_mesh_2d((2, 4), device=device)
    topo = topology_of(mesh, periodic=True)
    if cfg.stencil_height // 2 < 1 or cfg.stencil_width // 2 < 1:
        raise SystemExit(
            f"stencil {cfg.stencil_height}x{cfg.stencil_width} has no ghost "
            "ring (halo = stencil//2 = 0); use >= 2x2"
        )
    lay = TileLayout.for_stencil(tile_h, tile_w, cfg.stencil_height, cfg.stencil_width)
    spec = HaloSpec(layout=lay, topology=topo, axes=tuple(mesh.axis_names))

    hy, hx = lay.halo_y, lay.halo_x
    tiles = np.full((2, 4) + lay.padded_shape, -1.0, dtype=np.float32)
    for r in topo.ranks():
        rr, cc = topo.coords(r)
        tiles[rr, cc, hy:-hy, hx:-hx] = r

    # the stacked tile tensor is (rows, cols, ph, pw): the exchange takes it whole
    f = run_spmd(mesh, lambda x: halo_exchange(x[:, :, 0, 0], spec)[:, :, None, None],
                 P("row", "col", None, None), P("row", "col", None, None))
    out = f(torch.from_numpy(tiles).to(device)).cpu().numpy()

    made = outdir is None
    outdir = pathlib.Path(tempfile.mkdtemp(prefix="stencil2d_") if made else outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    for r in topo.ranks():
        rr, cc = topo.coords(r)
        with (outdir / coord_filename((rr, cc))).open("w") as fh:
            fh.write(f"Rank: {r}\nCoord: {rr}, {cc}\n\nArray after exchange\n")
            for row in out[rr, cc]:
                fh.write(" ".join(f"{v:.0f}" for v in row) + "\n")
    print(f"per-rank dumps written to {outdir} (cf. stencil2d/sample-output)")
    if made and "PYTEST_CURRENT_TEST" in os.environ:  # don't leak dumps from CI runs
        shutil.rmtree(outdir, ignore_errors=True)
    print("rank 0 tile after exchange (core=0, halo=neighbor ids):")
    print(np.array2string(out[0, 0], precision=0))

    steps = cfg.steps
    banner(f"real compute: {steps} Jacobi iterations vs global oracle")
    rng = np.random.default_rng(0)
    world = rng.standard_normal((2 * tile_h * 4, 4 * tile_w * 2)).astype(np.float32)
    got = distributed_stencil(world, steps=steps, mesh=mesh, impl=cfg.impl or "xla")
    expect = world
    for _ in range(steps):
        expect = 0.25 * (
            np.roll(expect, 1, 0) + np.roll(expect, -1, 0)
            + np.roll(expect, 1, 1) + np.roll(expect, -1, 1)
        )
    err = np.abs(got - expect).max()
    print(f"max |distributed - global| after {steps} steps: {err:.2e} "
          f"({'PASSED' if err < 1e-5 else 'FAILED'})")


if __name__ == "__main__":
    main()
