"""Nonblocking neighbor exchange with open boundaries — mpi5/mpi6 parity.

The twin of ``examples/ex04_neighbor_exchange.py``. mpi5: every rank sends
its id to rank+-1 and receives theirs, boundary ranks skipping the missing
side. mpi6 adds a root gather of each rank's (left, self, right) triple
and a pretty print (mpi5.cpp:34-75, mpi6.cpp:89-106). One SPMD program
does both.
"""

from tpuscratch_torch.examples._common import N_DEVICES, banner, ensure_devices


def main(device=None) -> None:
    device = ensure_devices(device=device)
    import torch

    from tpuscratch_torch.comm import P, gather_to_root, neighbor_exchange, run_spmd
    from tpuscratch_torch.runtime.mesh import make_mesh_1d

    banner("neighbor exchange + gather (mpi5/mpi6)")
    mesh = make_mesh_1d("x", N_DEVICES, device=device)
    n = mesh.size

    def body(x):
        # exchange rank+1 so ppermute's zero fill decodes to -1 ("no
        # neighbor") and is never confused with rank 0's real id
        left, right = neighbor_exchange(x + 1.0, "x", periodic=False)
        triple = torch.stack([left - 1.0, x, right - 1.0], dim=-2)  # (3, 1) a rank
        return gather_to_root(triple, "x")                          # (n, 3, 1) on root

    f = run_spmd(mesh, body, P("x"), P("x", None))
    out = f(torch.arange(n, dtype=torch.float32, device=device)).cpu().numpy()
    root_view = out[:n, :, 0]  # root rank's gathered block
    print("rank: (from-left, self, from-right)  [-1 = open boundary]")
    for r, (left, me, right) in enumerate(root_view):
        print(f"  {r}: ({left:.0f}, {me:.0f}, {right:.0f})")


if __name__ == "__main__":
    main()
