"""Distributed dot product with kernel strategy selection and timing —
mpicuda2/3/4 parity.

The twin of ``examples/ex08_dot_product.py``. The reference shards two big
vectors across ranks, reduces each shard on the GPU (three kernel
strategies), then MPI_Reduces to rank 0, timing the whole thing with the
max-min convention. Here: 8 ranks stacked on the device, the hand-written
dot kernel over every shard in one launch ('partials': a partial a chunk
summed in the same launch, 'full': one accumulator; 'xla' the plain torch
path), one allreduce, fenced timing (``bench.dot_bench.bench_dot``).
"""

from tpuscratch_torch.examples._common import N_DEVICES, banner, ensure_devices


def main(argv=None, device=None) -> None:
    device = ensure_devices(device=device)
    from tpuscratch_torch.bench.dot_bench import bench_dot
    from tpuscratch_torch.runtime.config import Config
    from tpuscratch_torch.runtime.mesh import make_mesh_1d

    # argv tier (mpi-pingpong-gpu.cpp:31 / mpicuda argv parity):
    #   ex08_dot_product [elements] [--impl=full|partials|xla]
    cfg = Config.load(argv)
    banner("distributed dot product (mpicuda2-4)")
    mesh = make_mesh_1d("x", N_DEVICES, device=device)
    n = cfg.elements if "elements" in cfg.explicit else 1 << 22
    methods = (cfg.impl,) if cfg.impl else ("full", "partials", "xla")
    for method in methods:
        res = bench_dot(mesh, n_elems=n, method=method, iters=3)
        print(res.summary())
    print("self-check vs n*1.0: PASSED (bench_dot asserts internally)")


if __name__ == "__main__":
    main()
