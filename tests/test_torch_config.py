"""tpuscratch_torch.runtime.{config,log,hostenv} against their JAX twins.

``Config``: every argv, env and flag form parses to the same fields in both
packages (the same ``explicit`` provenance), and both refuse the same
inputs with the same message; ``torch_dtype`` is ``jnp_dtype``'s twin.
``RankLogger`` and ``coord_filename`` write the same text. ``hostenv``
keeps the JAX names with the port's meaning: the card unless the CPU is
asked for (``TPUSCRATCH_ON_CPU``), no card and no request raising.
"""

import dataclasses
import io

import jax.numpy as jnp
import pytest
import torch

from tpuscratch.runtime import config as jc
from tpuscratch.runtime import hostenv as jh
from tpuscratch.runtime import log as jl
from tpuscratch_torch.runtime import config as tc
from tpuscratch_torch.runtime import hostenv as th
from tpuscratch_torch.runtime import log as tl


def _fields(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    out["error_policy"] = cfg.error_policy.value
    return out


def _both(fn):
    """(port result, JAX result) of ``fn(module)``, or the error each raised."""
    out = []
    for mod in (tc, jc):
        try:
            out.append(fn(mod))
        except Exception as e:  # noqa: BLE001 — compared below
            out.append((type(e).__name__, str(e)))
    return out


ARGV = [
    [], ["32", "24"], ["32", "24", "3"], ["32", "24", "3", "7"], ["1048576"],
    ["--steps=50", "--impl=pallas"], ["128", "128", "--steps=64", "--impl=pallas"],
    ["--mesh-shape=2x4", "--periodic=false"], ["--use_pallas=0", "--dtype=bfloat16"],
    ["--error-policy=abort", "--log=no"], ["--kv_dtype=int8", "--spec=2", "--page_size=16"],
    ["100000000", "--impl=partials"], ["--elements=4096", "5"],
]


class TestConfig:
    def test_defaults(self):
        t, j = tc.Config(), jc.Config()
        assert _fields(t) == _fields(j)
        assert t.halo_width == j.halo_width == 2 and t.halo_height == j.halo_height == 2
        assert t.torch_dtype == torch.float32 and j.jnp_dtype == jnp.float32
        assert t.explicit == j.explicit == frozenset()

    @pytest.mark.parametrize("argv", ARGV, ids=[" ".join(a) or "empty" for a in ARGV])
    def test_argv_and_flags(self, argv):
        t, j = _both(lambda m: m.Config.from_argv(argv))
        assert _fields(t) == _fields(j)
        t, j = _both(lambda m: m.Config.load(argv))
        assert _fields(t) == _fields(j) and t.explicit == j.explicit

    def test_overrides_win_over_argv(self):
        t, j = _both(lambda m: m.Config.from_argv(["32", "24", "--steps=9"], steps=3,
                                                  tile_width=7))
        assert _fields(t) == _fields(j) and t.steps == 3 and t.tile_width == 7

    @pytest.mark.parametrize("env", [
        {"TPUSCRATCH_DTYPE": "bfloat16", "TPUSCRATCH_NO_LOG": "1", "TPUSCRATCH_MESH": "2x4"},
        {"TPUSCRATCH_ABORT_ON_ERROR": "yes"}, {"TPUSCRATCH_ABORT_ON_ERROR": "0"},
        {"TPUSCRATCH_NO_LOG": "true"}, {"TPUSCRATCH_NO_LOG": "0"}, {},
    ])
    def test_env(self, env):
        t, j = _both(lambda m: m.Config.from_env(env))
        assert _fields(t) == _fields(j)
        t, j = _both(lambda m: m.Config.from_env(env, steps=11))
        assert _fields(t) == _fields(j)

    def test_load_env_then_argv(self, monkeypatch):
        monkeypatch.setenv("TPUSCRATCH_MESH", "4x2")
        monkeypatch.setenv("TPUSCRATCH_DTYPE", "float64")
        t, j = _both(lambda m: m.Config.load(["--dtype=int32", "16", "8"]))
        assert _fields(t) == _fields(j) and t.explicit == j.explicit
        assert t.mesh_shape == (4, 2) and t.dtype == "int32"
        assert t.explicit == {"mesh_shape", "dtype", "tile_width", "tile_height"}
        assert t.torch_dtype == torch.int32

    @pytest.mark.parametrize("argv", [["--steps"], ["--no_such=1"], ["--steps=x"],
                                      ["--mesh_shape=2xq"], ["--error_policy=explode"]])
    def test_refusals(self, argv):
        t, j = _both(lambda m: m.Config.from_argv(argv))
        assert isinstance(t, tuple) and t == j

    def test_dtypes(self):
        for name, want in (("float32", torch.float32), ("bfloat16", torch.bfloat16),
                           ("float64", torch.float64), ("int32", torch.int32)):
            assert tc.Config(dtype=name).torch_dtype == want
        t, j = _both(lambda m: getattr(m.Config(dtype="float16x"),
                                       "torch_dtype" if m is tc else "jnp_dtype"))
        assert t == j and t[0] == "ValueError"

    def test_replace_drops_provenance(self):
        t = tc.Config.load(["--steps=4"])
        assert t.explicit == {"steps"}
        r = t.replace(steps=5)
        assert r.steps == 5 and r.explicit == frozenset()
        assert _fields(r) == _fields(jc.Config.load(["--steps=4"]).replace(steps=5))


class TestRankLogger:
    @staticmethod
    def _text(mod, **kw) -> str:
        out = io.StringIO()
        calls = kw.pop("calls")
        with mod.RankLogger(stream=out, **kw) as log:
            for fn, args in calls:
                getattr(log, fn)(*args)
            mid = out.getvalue()
        return mid + "|" + out.getvalue()

    @pytest.mark.parametrize("kw", [
        dict(rank=2, coords=(0, 2)), dict(rank=1, buffered=True), dict(enabled=False),
        dict(rank=3), dict(rank=0), dict(), dict(coords=[1, 1], buffered=True),
    ])
    def test_same_text(self, kw):
        calls = [("log", ("hello", 3)), ("__call__", ("called",)), ("log0", ("root only",)),
                 ("log", (1.5, None))]
        assert self._text(tl, calls=calls, **kw) == self._text(jl, calls=calls, **kw)

    def test_prefix_and_flush(self):
        out = io.StringIO()
        log = tl.RankLogger(rank=1, coords=(0, 1), buffered=True, stream=out)
        log("a")
        assert out.getvalue() == "" and log.prefix == "[rank 1 (0,1)] "
        log.flush()
        assert out.getvalue() == "[rank 1 (0,1)] a\n"

    @pytest.mark.parametrize("coords,prefix", [((0, 2), ""), ((1, 1), "tile_"), ((2, 0, 3), "z")])
    def test_coord_filename(self, coords, prefix):
        assert tl.coord_filename(coords, prefix) == jl.coord_filename(coords, prefix)


class TestHostenv:
    def test_same_names(self):
        for name in ("force_cpu_devices", "on_device_requested", "ensure_devices"):
            assert callable(getattr(th, name)) and callable(getattr(jh, name))

    def test_cpu_request(self, monkeypatch):
        monkeypatch.delenv(th.CPU_ENV, raising=False)
        assert th.on_device_requested()
        assert th.ensure_devices(8, device="cpu") == torch.device("cpu")
        for value in ("1", "true", "YES", " on "):
            monkeypatch.setenv(th.CPU_ENV, value)
            assert not th.on_device_requested()
            assert th.ensure_devices(8) == torch.device("cpu")
        monkeypatch.setenv(th.CPU_ENV, "0")
        assert th.on_device_requested()

    def test_force_cpu_devices(self, monkeypatch):
        monkeypatch.delenv(th.CPU_ENV, raising=False)
        th.force_cpu_devices(8)
        assert th.ensure_devices() == torch.device("cpu")
        with pytest.raises(ValueError):
            th.force_cpu_devices(0)
        with pytest.raises(ValueError):
            th.ensure_devices(0)

    def test_no_card_and_no_request_raises(self, monkeypatch):
        monkeypatch.delenv(th.CPU_ENV, raising=False)
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            th.ensure_devices(8)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            th.ensure_devices(8, device="cuda")
