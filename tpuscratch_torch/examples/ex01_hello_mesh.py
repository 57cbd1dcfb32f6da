"""Runtime bring-up: process identity, device, mesh — mpi1/mpi2 parity.

The twin of ``examples/ex01_hello_mesh.py``. The reference's hello world
prints rank, size and processor name after MPI_Init (mpi1.cpp), and mpi2
adds error-handler installation. Here: ``initialize()``, the per-process
hello line, a mesh of 8 ranks stacked on the device, and the error-policy
guard around the whole bring-up.
"""

from tpuscratch_torch.examples._common import N_DEVICES, banner, ensure_devices


def main(device=None) -> None:
    device = ensure_devices(device=device)
    from tpuscratch_torch.runtime.context import initialize
    from tpuscratch_torch.runtime.errors import ErrorPolicy, guarded
    from tpuscratch_torch.runtime.log import RankLogger
    from tpuscratch_torch.runtime.mesh import make_mesh_1d

    banner("hello mesh")
    with guarded("bring-up", ErrorPolicy.RAISE):
        ctx = initialize(device=device)
        print(ctx.hello())
        mesh = make_mesh_1d("world", N_DEVICES, device=device)
        log = RankLogger(rank=ctx.process_index)
        log(f"mesh axes {mesh.axis_names}, {mesh.size} ranks stacked on {mesh.device}:")
        for r in range(mesh.size):
            log(f"  rank {r}: slice {r} of the stacked tensors on {mesh.device}")


if __name__ == "__main__":
    main()
