"""Derived-datatype equivalents — mpi7/mpi8/mpi-complex-types parity.

The twin of ``examples/ex05_structured_slices.py``: three reference
programs in one example, each with a slice spec (``tpuscratch_torch.
dtypes``) instead of a committed MPI datatype:
- indexed blocks of a 16-float array broadcast to all ranks (mpi7);
- Particle records {4 floats; 2 ints} scattered from root (mpi8), the
  struct type a dict of tensors, struct-of-arrays;
- runs of three separately allocated arrays sent as one payload
  (mpi-complex-types): pointer displacements become list indices.
"""

from tpuscratch_torch.examples._common import N_DEVICES, banner, ensure_devices


def main(device=None) -> None:
    device = ensure_devices(device=device)
    import torch

    from tpuscratch_torch.comm import P, broadcast, run_spmd, scatter_from_root
    from tpuscratch_torch.dtypes import HIndexedSpec, IndexedSpec, StructSpec
    from tpuscratch_torch.runtime.mesh import make_mesh_1d

    mesh = make_mesh_1d("x", N_DEVICES, device=device)
    n = mesh.size

    banner("indexed blocks (mpi7)")
    spec = IndexedSpec(((5, 4), (12, 2)))  # len 4 @ 5, len 2 @ 12
    data = torch.arange(16.0, device=device)
    f = run_spmd(mesh, lambda x: broadcast(spec.pack(x), "x"), P(), P(None))
    print("root's blocks as 6 plain floats on every rank:", f(data).cpu().numpy()[:6])

    banner("struct scatter (mpi8)")
    particles = {
        "pos": torch.arange(2 * n, dtype=torch.float32, device=device),
        "vel": torch.arange(2 * n, dtype=torch.float32, device=device) * 2,
        "id": torch.arange(2 * n, dtype=torch.int32, device=device),
    }
    sspec = StructSpec(("pos", "vel", "id"))
    sspec.validate(particles)
    g = run_spmd(mesh, lambda t: {k: scatter_from_root(a, "x") for k, a in t.items()},
                 P(), P("x"))
    out = g(particles)
    print(f"2 particles per rank; rank 1 got ids {out['id'].cpu().numpy()[2:4]}")

    banner("nested slices of separate arrays (mpi-complex-types)")
    a, b, c = (torch.arange(10.0 * i, 10.0 * (i + 1), device=device) for i in range(3))
    hspec = HIndexedSpec((
        (0, IndexedSpec(((2, 3),))),
        (1, IndexedSpec(((0, 3),))),
        (2, IndexedSpec(((5, 3),))),
    ))
    payload = hspec.pack([a, b, c])
    print("one payload from 3 arrays:", payload.cpu().numpy())


if __name__ == "__main__":
    main()
