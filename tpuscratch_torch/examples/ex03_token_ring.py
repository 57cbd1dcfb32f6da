"""Lock-step token passing — mpi4 parity, generalized to the full ring.

The twin of ``examples/ex03_token_ring.py``. The reference bounces an
incrementing counter between two ranks for 10 rounds (mpi4.cpp:24-44);
here the token circulates the whole ring, one ppermute a hop.
"""

from tpuscratch_torch.examples._common import N_DEVICES, banner, ensure_devices


def main(device=None) -> None:
    device = ensure_devices(device=device)
    import torch

    from tpuscratch_torch.comm import P, run_spmd, token_ring
    from tpuscratch_torch.runtime.mesh import make_mesh_1d

    banner("token ring (mpi4)")
    mesh = make_mesh_1d("x", N_DEVICES, device=device)
    n = mesh.size
    hops = 10
    f = run_spmd(mesh, lambda x: token_ring(x, "x", hops=hops), P("x"), P("x"))
    out = f(torch.zeros(n, device=device)).cpu().numpy()
    print(f"{hops} hops around a {n}-ring, +1 per hop:")
    print("final tokens per rank:", out)


if __name__ == "__main__":
    main()
