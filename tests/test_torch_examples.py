"""The port's examples (``tpuscratch_torch/examples``) against the JAX
package's (``examples/``): each runs through its ``main()`` on the CPU (8
ranks stacked there, 8 virtual devices on the JAX side), prints its banner,
reaches its self-check where the JAX twin has one and never prints FAILED,
and its deterministic lines equal the JAX example's line for line.

Dropped before the comparison, by name:
- timing lines: every ``BenchResult.summary()`` line (the dot, pingpong and
  host-staging rates; they hold ``p50``) and ex24's ``wall:`` line;
- temporary paths: ex09's ``per-rank dumps written to <dir>`` line;
- device identity: ex01's hello line and its ``[rank 0]`` lines, which name
  the JAX example's 8 virtual CPU devices and the port's one device (their
  count is compared instead).
"""

import importlib
import inspect
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

torch.set_num_threads(1)

EXAMPLES = sorted(p.stem for p in (ROOT / "tpuscratch_torch" / "examples").glob("ex*.py"))


def _dropped(name: str, line: str) -> bool:
    if " p50 " in line or line.startswith("per-rank dumps written to "):
        return True
    if name == "ex24_serving" and line.startswith("wall: "):
        return True
    return name == "ex01_hello_mesh" and (line.startswith("process ") or line.startswith("[rank"))


def _run(main, capsys, **kw) -> str:
    if "argv" in inspect.signature(main).parameters:
        kw["argv"] = []
    main(**kw)
    return capsys.readouterr().out


def test_every_jax_example_1_to_10_has_a_twin():
    # ex01-ex10, and the later examples whose modules have landed (ex24: serving)
    jax_names = sorted(p.stem for p in (ROOT / "examples").glob("ex*.py")
                       if int(p.stem[2:4]) <= 10 or int(p.stem[2:4]) == 24)
    assert EXAMPLES == jax_names


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_twin(name, capsys):
    port = importlib.import_module(f"tpuscratch_torch.examples.{name}")
    got = _run(port.main, capsys, device="cpu")
    want = _run(importlib.import_module(f"examples.{name}").main, capsys)
    assert got.startswith("== ") and "FAILED" not in got
    if '"PASSED"' in (ROOT / "examples" / f"{name}.py").read_text():
        assert "PASSED" in got
    keep = lambda out: [ln for ln in out.splitlines() if not _dropped(name, ln)]  # noqa: E731
    assert keep(got) == keep(want)
    if name == "ex01_hello_mesh":
        count = lambda out: sum(ln.startswith("[rank 0]") for ln in out.splitlines())  # noqa: E731
        assert count(got) == count(want) == 9
    else:
        assert len(got.splitlines()) - len(keep(got)) == len(want.splitlines()) - len(
            keep(want)) + (2 if name == "ex10_pingpong" else 0)  # the native-pool A/B pair


def test_examples_run_as_modules_on_the_cpu(tmp_path):
    # ``python -m tpuscratch_torch.examples.exNN`` with the CPU asked for by
    # the environment; without a card and without it, the example exits
    import os
    import subprocess

    env = dict(os.environ, TPUSCRATCH_ON_CPU="1",
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-m", "tpuscratch_torch.examples.ex09_stencil2d",
                          "16", "8", "--steps=3", "--impl=pallas"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "after 3 steps" in out.stdout and "(PASSED)" in out.stdout
    if not torch.cuda.is_available():
        env.pop("TPUSCRATCH_ON_CPU")
        out = subprocess.run([sys.executable, "-m", "tpuscratch_torch.examples.ex02_pair_exchange"],
                             cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
        assert out.returncode != 0 and "no CUDA device" in out.stderr


def test_ex09_writes_the_reference_dumps(tmp_path, capsys):
    # the per-rank files of the reference's sample-output, named by coords
    ex09 = importlib.import_module("tpuscratch_torch.examples.ex09_stencil2d")
    ex09.main([], device="cpu", outdir=tmp_path / "dumps")
    capsys.readouterr()
    names = sorted(p.name for p in (tmp_path / "dumps").iterdir())
    assert names == [f"{r}_{c}" for r in range(2) for c in range(4)]
    text = (tmp_path / "dumps" / "1_2").read_text().splitlines()
    assert text[:3] == ["Rank: 6", "Coord: 1, 2", ""] and len(text) == 4 + 12
