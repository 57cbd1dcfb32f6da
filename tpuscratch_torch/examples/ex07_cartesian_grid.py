"""2D cartesian topology with 4-neighbor exchange — mpi10 parity.

The twin of ``examples/ex07_cartesian_grid.py``. The reference builds a
sqrt(N) x sqrt(N) non-periodic grid, finds each rank's 4-neighborhood with
MPI_Cart_shift, and exchanges ids with 8 nonblocking ops + waitall
(mpi10.cpp:27-54). Here the topology is a value object whose shift tables
become four ppermutes.
"""

from tpuscratch_torch.examples._common import banner, ensure_devices


def main(device=None) -> None:
    device = ensure_devices(device=device)
    import torch

    from tpuscratch_torch.comm import P, run_spmd
    from tpuscratch_torch.comm.p2p import ppermute
    from tpuscratch_torch.runtime.mesh import make_mesh_2d, topology_of
    from tpuscratch_torch.runtime.topology import Direction

    banner("cartesian 4-neighborhood (mpi10)")
    mesh = make_mesh_2d((2, 4), device=device)
    topo = topology_of(mesh, periodic=False)
    print("grid (rank map):")
    print(topo.grid_string())

    def body(x):
        received = []
        for d in (Direction.TOP, Direction.BOTTOM, Direction.LEFT, Direction.RIGHT):
            perm = topo.send_permutation(d.opposite)  # receive from d
            # send rank+1: the zero fill decodes to -1, distinct from rank 0
            received.append(ppermute(x + 1.0, ("row", "col"), perm) - 1.0)
        return tuple(received)

    ids = torch.arange(topo.size, dtype=torch.float32, device=device).reshape(topo.dims)
    f = run_spmd(mesh, body, P("row", "col"), tuple(P("row", "col") for _ in range(4)))
    top, bottom, left, right = (o.cpu().numpy() for o in f(ids))
    for r in range(topo.size):
        rr, cc = topo.coords(r)
        print(
            f"rank {r} ({rr},{cc}): top={top[rr, cc]:.0f} bottom={bottom[rr, cc]:.0f} "
            f"left={left[rr, cc]:.0f} right={right[rr, cc]:.0f}  [-1 = none]"
        )


if __name__ == "__main__":
    main()
