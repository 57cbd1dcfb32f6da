"""Sub-communicators via mesh axes — mpi9 parity.

The twin of ``examples/ex06_subgroups.py``. The reference splits the world
into two halves with MPI groups, allreduces within each half AND across
the world, and shows the rank renumbering (mpi9.cpp:27-73). Here the split
is a second mesh axis: a sum over 'local' is the per-half reduce, over
both axes the world reduce, and the "renumbered rank" is
``axis_index('local')``.
"""

from tpuscratch_torch.examples._common import banner, ensure_devices


def main(device=None) -> None:
    device = ensure_devices(device=device)
    import torch

    from tpuscratch_torch.comm import P, allreduce_sum, run_spmd
    from tpuscratch_torch.comm.spmd import axis_index
    from tpuscratch_torch.runtime.mesh import make_mesh

    banner("sub-group allreduce (mpi9)")
    mesh = make_mesh((2, 4), ("half", "local"), device=device)

    def body(x):
        per_half = allreduce_sum(x, "local")
        world = allreduce_sum(x, ("half", "local"))
        my_local_rank = axis_index("local")  # renumbered rank, (2, 4)
        return per_half, world, my_local_rank.to(torch.float32)[..., None]

    f = run_spmd(
        mesh, body, P("half", "local"),
        (P("half", "local"), P("half", "local"), P(("half", "local"))),
    )
    vals = torch.arange(8, dtype=torch.float32, device=device).reshape(2, 4)
    per_half, world, local_ranks = (o.cpu().numpy() for o in f(vals))
    print("values:", vals.tolist())
    print("per-half sums:", per_half[:, 0].tolist(), "(each half concurrent)")
    print("world sum:", world[0, 0])
    print("renumbered local ranks:", local_ranks.tolist())


if __name__ == "__main__":
    main()
