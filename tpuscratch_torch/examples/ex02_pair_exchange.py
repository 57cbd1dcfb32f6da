"""Two ranks exchange messages — mpi3 parity.

The twin of ``examples/ex02_pair_exchange.py``. The reference sizes the
receive buffer at run time with MPI_Probe + MPI_Get_count (mpi3.cpp:28-32);
here shapes are known before the exchange, so the "probe" is the payload's
shape. The exchange itself is one ppermute with the pair table
[(0,1),(1,0)].
"""

from tpuscratch_torch.examples._common import N_DEVICES, banner, ensure_devices


def main(device=None) -> None:
    device = ensure_devices(device=device)
    import torch

    from tpuscratch_torch.comm import P, run_spmd, send_pairs
    from tpuscratch_torch.runtime.mesh import make_mesh_1d

    banner("pair exchange (mpi3)")
    mesh = make_mesh_1d("x", N_DEVICES, device=device)
    n = mesh.size
    f = run_spmd(mesh, lambda x: send_pairs(x, "x", [(0, 1), (1, 0)]), P("x"), P("x"))
    # rank 0 holds 100, rank 1 holds 200; after the exchange they swap
    vals = torch.tensor([100.0, 200.0] + [0.0] * (n - 2), device=device)
    out = f(vals).cpu().numpy()
    print(f"before: rank0={vals[0].item()}, rank1={vals[1].item()}")
    print(f"after : rank0={out[0]}, rank1={out[1]} (swapped)")


if __name__ == "__main__":
    main()
