"""tpuscratch_torch stands alone: no module of it (nor chip_smoke.py)
imports JAX or anything of tpuscratch, importing builds no kernel, and
the card-side script refuses to run without a card."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, json, pkgutil, sys
import tpuscratch_torch
names = ["tpuscratch_torch"] + [m.name for m in pkgutil.walk_packages(
    tpuscratch_torch.__path__, "tpuscratch_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
from tpuscratch_torch.ops import common
print(json.dumps({
    "modules": names,
    "foreign": sorted(m for m in sys.modules
                      if m == "jax" or m.startswith(("jax.", "jaxlib"))
                      or m == "tpuscratch" or m.startswith("tpuscratch.")),
    "libs": sorted(common._libs),
}))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_no_jax_and_no_build_at_import():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["foreign"] == []
    assert got["libs"] == []
    for mod in ("tpuscratch_torch.runtime.topology", "tpuscratch_torch.halo.exchange",
                "tpuscratch_torch.ops.stencil_kernel", "tpuscratch_torch.bench.headline",
                "tpuscratch_torch.comm.collectives", "tpuscratch_torch.ops.reduction",
                "tpuscratch_torch.ops.fill", "tpuscratch_torch.bench.dot_bench",
                "tpuscratch_torch.bench.pingpong", "tpuscratch_torch.ops.stencil_stream",
                "tpuscratch_torch.ops.halo_dma", "tpuscratch_torch.bench.record",
                "tpuscratch_torch.halo.halo3d", "tpuscratch_torch.bench.stencil_bench",
                "tpuscratch_torch.serve", "tpuscratch_torch.serve.kvcache",
                "tpuscratch_torch.serve.sampling", "tpuscratch_torch.serve.decode",
                "tpuscratch_torch.serve.engine", "tpuscratch_torch.ops.attention",
                "tpuscratch_torch.parallel.scores", "tpuscratch_torch.parallel.expert",
                "tpuscratch_torch.models.transformer", "tpuscratch_torch.bench.decode_bench",
                "tpuscratch_torch.parallel.ring", "tpuscratch_torch.parallel.ring_attention",
                "tpuscratch_torch.parallel.ulysses", "tpuscratch_torch.bench.train_bench",
                "tpuscratch_torch.bench.attention_bench", "tpuscratch_torch.bench.attn_bwd_bench",
                "tpuscratch_torch.ops.adam", "tpuscratch_torch.models.zero",
                "tpuscratch_torch.bench.adam_bench", "tpuscratch_torch.bench.dma_bound",
                "tpuscratch_torch.parallel.plan", "tpuscratch_torch.parallel.pipeline",
                "tpuscratch_torch.parallel.ssm", "tpuscratch_torch.models.ssm",
                "tpuscratch_torch.bench.train_ablation", "tpuscratch_torch.bench.pipeline_bench",
                "tpuscratch_torch.solvers", "tpuscratch_torch.solvers.cg",
                "tpuscratch_torch.solvers.spectral", "tpuscratch_torch.solvers.multigrid",
                "tpuscratch_torch.solvers.multigrid3d", "tpuscratch_torch.parallel.fft",
                "tpuscratch_torch.bench.fft_bench", "tpuscratch_torch.bench.mg3d_chip",
                "tpuscratch_torch.obs", "tpuscratch_torch.obs.sink",
                "tpuscratch_torch.obs.metrics", "tpuscratch_torch.obs.trace",
                "tpuscratch_torch.obs.goodput", "tpuscratch_torch.obs.report",
                "tpuscratch_torch.ft", "tpuscratch_torch.ft.retry", "tpuscratch_torch.ft.guards",
                "tpuscratch_torch.ft.chaos", "tpuscratch_torch.ft.supervisor",
                "tpuscratch_torch.runtime.checkpoint", "tpuscratch_torch.runtime.async_ckpt",
                "tpuscratch_torch.runtime.chunked", "tpuscratch_torch.models.trainer",
                "tpuscratch_torch.solvers.runner", "tpuscratch_torch.obs.ledger",
                "tpuscratch_torch.obs.regress", "tpuscratch_torch.runtime.profiling",
                "tpuscratch_torch.runtime.scheduler", "tpuscratch_torch.bench.weak_scaling"):
        assert mod in got["modules"]


def test_chip_smoke_needs_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=240)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    # a directory holding chip_smoke.py and nothing else of the repo
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_build_without_nvcc_raises(monkeypatch):
    from tpuscratch_torch.ops import common

    if shutil.which("nvcc") or pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is installed")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        common.nvcc_path()


def test_sources_ship_as_package_data():
    from tpuscratch_torch.ops import common

    assert sorted(p.name for p in common.CSRC.glob("*.cu")) == [
        "adam.cu", "copy_probes.cu", "fill.cu", "flash_attention.cu", "halo_dma.cu",
        "paged_attention.cu", "reduction.cu", "stencil2d.cu", "stencil3d.cu",
        "stencil_stream2d.cu", "stencil_stream3d.cu"]
    assert sorted(p.name for p in common.CSRC.glob("*.cuh")) == ["hopper.cuh", "stencil_taps.cuh"]
    assert common.BUILD_DIR == ROOT / "build" / "tpuscratch_torch"
    assert '"tpuscratch_torch" = ["csrc/*.cu", "csrc/*.cuh"]' in (ROOT / "pyproject.toml").read_text()


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    import torch

    from tpuscratch_torch.bench.dot_bench import bench_dot
    from tpuscratch_torch.ops.fill import fill
    from tpuscratch_torch.runtime.mesh import make_mesh_1d
    from tpuscratch_torch.models.transformer import TransformerConfig, init_params, train_step
    from tpuscratch_torch.serve import CacheGeometry, init_kv_cache, request_key
    from tpuscratch_torch.bench.attention_bench import bench_attention
    from tpuscratch_torch.bench.train_bench import bench_train
    from tpuscratch_torch.runtime.mesh import make_mesh

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for call in (make_mesh_1d, lambda: fill((8, 128), 1.0), lambda: bench_dot(n_elems=64),
                 lambda: init_params(0, TransformerConfig()),
                 lambda: init_kv_cache(CacheGeometry(1, 2, 4, 2, 8)),
                 lambda: request_key(0, 0, 0),
                 lambda: train_step(make_mesh((1, 1), ("dp", "sp")), TransformerConfig()),
                 bench_train, lambda: bench_attention(S=16, H=2, D=8, rounds=1, iters=1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert make_mesh_1d(device="cpu").shape == (1,)
    assert bench_attention(S=16, H=2, D=8, rounds=1, iters=1, device="cpu").items > 0
    assert bench_train(make_mesh((1, 1), ("dp", "sp"), device="cpu"), iters=1).items > 0


def test_zero_and_probe_entry_points_need_a_card_unless_asked_for_the_cpu():
    import torch

    from tpuscratch_torch.bench import adam_bench, dma_bound
    from tpuscratch_torch.bench.record import config13_zero_train
    from tpuscratch_torch.bench.train_bench import bench_train
    from tpuscratch_torch.models.transformer import TransformerConfig
    from tpuscratch_torch.models.zero import (init_zero_adam_state, train_step_zero,
                                              zero_state_from_numpy)
    from tpuscratch_torch.runtime.mesh import make_mesh

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = TransformerConfig(n_experts=2)
    for call in (lambda: train_step_zero(make_mesh((1, 1), ("dp", "sp")), cfg),
                 lambda: bench_train(optimizer="adam", zero=True),
                 lambda: config13_zero_train([]), adam_bench.race,
                 lambda: dma_bound.race("copy_", dma_bound.library_copy()),
                 lambda: zero_state_from_numpy({"mu_flat": [], "nu_flat": [], "mu_exp": [],
                                                "nu_exp": [], "t": 0})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    mesh = make_mesh((1, 1), ("dp", "sp"), device="cpu")
    assert bench_train(mesh, optimizer="adam", zero=True, accum_steps=2, iters=1).items > 0
    with pytest.raises(RuntimeError, match="needs the card"):
        adam_bench.race(device="cpu")
    state = init_zero_adam_state({"layers": [{"wq": torch.zeros(3)}]}, 1)
    assert state["mu_flat"].device.type == "cpu" and state["mu_flat"].shape == (8,)


def test_solver_entry_points_need_a_card_unless_asked_for_the_cpu():
    import numpy as np
    import torch

    from tpuscratch_torch import solvers
    from tpuscratch_torch.bench import fft_bench, mg3d_chip
    from tpuscratch_torch.bench.record import config8_dft

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    b2, b3 = np.ones((16, 16), np.float32), np.ones((16, 16, 16), np.float32)
    for call in (lambda: solvers.poisson_solve(b2), lambda: solvers.mg_poisson_solve(b2),
                 lambda: solvers.pcg_poisson_solve(b2), lambda: solvers.mg_poisson3d_solve(b3),
                 lambda: solvers.pcg_poisson3d_solve(b3), lambda: solvers.periodic_poisson_fft(b2),
                 lambda: solvers.periodic_poisson3d_fft(b3), fft_bench.bench_dft,
                 lambda: mg3d_chip.race(16, levels=2), lambda: config8_dft([])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert solvers.mg_poisson3d_solve(b3 - 1.0, device="cpu")[1] == 0
    assert set(mg3d_chip.race(16, levels=2, smoothers=("rbgs",), device="cpu", iters=1)) == {"rbgs"}


def test_chunked_entry_points_need_a_card_unless_asked_for_the_cpu(tmp_path):
    import numpy as np
    import torch

    from tpuscratch_torch.bench.record import config16_elastic_goodput
    from tpuscratch_torch.halo.driver import checkpointed_stencil
    from tpuscratch_torch.models.trainer import synthetic_batch, train
    from tpuscratch_torch.models.transformer import TransformerConfig
    from tpuscratch_torch.runtime.mesh import make_mesh
    from tpuscratch_torch.solvers.runner import checkpointed_mg3d_solve

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    w, b = np.ones((8, 8), np.float32), np.zeros((8, 8, 8), np.float32)
    for call in (lambda: checkpointed_stencil(w, 2, str(tmp_path / "a")),
                 lambda: checkpointed_mg3d_solve(b, str(tmp_path / "b")),
                 lambda: synthetic_batch(0, 0, 1, 2, 4),
                 lambda: train(make_mesh((1, 1), ("dp", "sp")), TransformerConfig(), 1,
                               str(tmp_path / "c")),
                 lambda: config16_elastic_goodput([])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert checkpointed_stencil(w, 2, str(tmp_path / "d"), save_every=1, device="cpu").shape == (8, 8)
