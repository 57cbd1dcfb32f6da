"""Pingpong latency/bandwidth probe — test-benchmark parity.

The twin of ``examples/ex10_pingpong.py``. The reference times one round
trip of N doubles between two GPUs through GPU-direct MPI, verifies the
echo, and prints PASSED with times (test-benchmark/mpi-pingpong-gpu.cpp).
Here the round trip is a ppermute pair between two of 8 ranks stacked on
the device (an on-card copy, no link crossed); the host-staging ablations
show what device-resident tensors save, and the native pool's buffer
against a pageable one isolates the host allocator (the reference's
host_allocator / PAGE_LOCKED switch).
"""

from tpuscratch_torch.examples._common import N_DEVICES, banner, ensure_devices


def main(argv=None, device=None) -> None:
    device = ensure_devices(device=device)
    from tpuscratch_torch.bench.pingpong import (
        host_staging_roundtrip,
        native_pool_staging_roundtrip,
        pageable_buffer_staging_roundtrip,
        sweep,
        verify_echo,
    )
    from tpuscratch_torch.runtime.config import Config
    from tpuscratch_torch.runtime.mesh import make_mesh_1d

    # argv tier: ex10_pingpong [max_message_bytes]
    # (message size from argv = mpi-pingpong-gpu.cpp:31)
    cfg = Config.load(argv)
    sizes = (8, 1024, 65536, 1 << 20)
    if "elements" in cfg.explicit:
        # sweep the presets below the requested size AND the size itself
        sizes = tuple(sorted({s for s in sizes if s < cfg.elements} | {cfg.elements}))
    banner("pingpong (test-benchmark)")
    mesh = make_mesh_1d("x", N_DEVICES, device=device)
    ok = verify_echo(mesh, "x", 4096)
    print(f"echo self-check: {'PASSED' if ok else 'FAILED'}")
    for res in sweep(mesh, sizes_bytes=sizes, iters=5):
        print(" ", res.summary())
    for stage in (host_staging_roundtrip, native_pool_staging_roundtrip,
                  pageable_buffer_staging_roundtrip):
        print(" ", stage(1 << 18, iters=5, device=device).summary(), "(ablation)")


if __name__ == "__main__":
    main()
