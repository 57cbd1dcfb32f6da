"""One typed configuration object replacing the reference's three config tiers.

The twin of ``tpuscratch.runtime.config``: the same fields, defaults,
provenance (``explicit``) and parsers, so a flag, an argv tier or an env
variable parses the same in both packages. ``torch_dtype`` takes the place
of ``jnp_dtype`` (float64 needs no x64 switch in torch), and
``use_pallas`` keeps its name because users type it: here it chooses the
hand-written CUDA kernel over the plain torch path.

The reference configures behavior through (a) compile-time ``#define``
switches — GPU, NO_LOG, REDUCE_CPU/REDUCE_GPU, DOUBLE_, MPI_RROBIN_,
NO_GPU_MALLOC_TIME, HOST_COPY, PAGE_LOCKED, MPI_ERR_USE_EXCEPTIONS
(mpicuda3.cu:18-24, mpi-pingpong-gpu-async.cpp:43-49,
mpierr.h:48) — (b) argv for sizes (mpi-pingpong-gpu.cpp:31,
mpi-2d-stencil-subarray-cuda.cu:131-138), and (c) env vars for runtime
discovery (MV2_COMM_WORLD_LOCAL_RANK etc., -cuda.cu:46-69). Here all of it
is one frozen dataclass, parseable from argv and env, passed explicitly.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import torch

from tpuscratch_torch.runtime.errors import ErrorPolicy

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float64": torch.float64,  # fp64 parity w/ DOUBLE_
    "int32": torch.int32,
}


@dataclasses.dataclass(frozen=True)
class Config:
    # -- compute path ----------------------------------------------------
    dtype: str = "float32"           # DOUBLE_ switch parity, but runtime-typed
    use_pallas: bool = True          # GPU vs host-loop switch parity: the
    #                                  hand-written kernel vs the plain path
    block_rows: int = 512            # kernel block shape (BLOCK_SIZE parity,
    #                                  mpicuda3.cu:65 raised 256->512)
    reduce_on_device: bool = True    # REDUCE_GPU vs host-accumulate parity
    # -- mesh ------------------------------------------------------------
    mesh_shape: Optional[tuple[int, ...]] = None  # None = auto (all devices)
    periodic: bool = True
    # -- problem sizes (argv tier) ---------------------------------------
    tile_width: int = 16             # reference default tile (subarray.cpp:71)
    tile_height: int = 16
    stencil_width: int = 5           # reference default 5x5 stencil
    stencil_height: int = 5
    elements: int = 1 << 20          # message/vector size (argv parity)
    steps: int = 5                   # iteration count for iterative drivers
    impl: str = ""                   # impl selector ("" = driver default);
    #                                  stencil: xla/pallas/blocked/overlap/
    #                                  deep/dma/resident, dot: full/partials/
    #                                  xla, attention: pallas/xla
    # -- serving (serve/engine.py knobs; argv tier like the sizes above) --
    decode_slots: int = 8            # continuous-batching decode-batch width
    kv_pages: int = 64               # KV-cache pages per dp group
    page_size: int = 8               # tokens per KV page
    kv_dtype: str = "float32"        # KV-page dtype: float32 | int8 | fp8
    #                                  (int8 = quantized pages, ~1/4 bytes)
    spec: int = 0                    # speculative draft tokens per verify
    #                                  sweep (0 = speculation off)
    # -- instrumentation -------------------------------------------------
    log: bool = True                 # NO_LOG parity
    include_setup_time: bool = True  # NO_GPU_MALLOC_TIME parity
    error_policy: ErrorPolicy = ErrorPolicy.RAISE  # MPI_ERR_USE_EXCEPTIONS

    def __post_init__(self):
        # provenance: which fields were EXPLICITLY set (Config.load fills
        # this) — so callers can distinguish "user asked for the default
        # value" from "user said nothing" without sentinel comparisons.
        # Not a dataclass field: replace()/asdict() reset it.
        if not hasattr(self, "explicit"):
            object.__setattr__(self, "explicit", frozenset())

    # ---- derived -------------------------------------------------------

    @property
    def torch_dtype(self) -> torch.dtype:
        try:
            return _DTYPES[self.dtype]
        except KeyError:
            raise ValueError(
                f"unknown dtype {self.dtype!r}; choose from {sorted(_DTYPES)}"
            ) from None

    @property
    def halo_width(self) -> int:
        # ghost depth = stencil//2, as in stencil2D.h:116-117
        return self.stencil_width // 2

    @property
    def halo_height(self) -> int:
        return self.stencil_height // 2

    # ---- construction --------------------------------------------------

    @classmethod
    def from_argv(cls, argv: Sequence[str], **overrides) -> "Config":
        """CLI parity with the reference drivers: positional
        ``[tile_w tile_h [stencil_w stencil_h]]`` (-cuda.cu:131-138, including
        fixing its stencilHeight self-assignment bug) or ``elements`` for the
        benchmarks (mpi-pingpong-gpu.cpp:31). Any field is also settable as
        ``--name=value`` (e.g. ``--steps=50 --impl=pallas``)."""
        fields = dict(overrides)
        for flag, value in _parse_flags(argv).items():
            fields.setdefault(flag, value)
        for key, value in _parse_positional(argv).items():
            fields.setdefault(key, value)
        return cls(**fields)

    @classmethod
    def load(cls, argv: Optional[Sequence[str]] = None) -> "Config":
        """The example/driver entry: env tier first, argv tier on top
        (argv wins — the reference's precedence, where a CLI tile size
        overrides whatever the job script exported). The returned
        config's ``explicit`` frozenset names every field that was
        actually set by either tier, so callers can distinguish an
        explicit request for the default value from silence."""
        import sys

        argv = list(sys.argv[1:]) if argv is None else list(argv)
        merged = {
            **_parse_env(dict(os.environ)),
            **_parse_positional(argv),
            **_parse_flags(argv),
        }
        cfg = cls(**merged)
        object.__setattr__(cfg, "explicit", frozenset(merged))
        return cfg

    @classmethod
    def from_env(cls, env: Optional[dict] = None, **overrides) -> "Config":
        """Env tier: TPUSCRATCH_* variables (runtime discovery only)."""
        fields = dict(overrides)
        for key, value in _parse_env(dict(os.environ if env is None else env)).items():
            fields.setdefault(key, value)
        return cls(**fields)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _coerce(name: str, default, value: str):
    """Parse a flag string by the FIELD DEFAULT's type (annotations are
    strings under ``from __future__ import annotations``)."""
    if name == "mesh_shape":
        return tuple(int(x) for x in value.split("x"))
    if name == "error_policy":
        return ErrorPolicy[value.upper()]
    if isinstance(default, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(value)
    return value


def _parse_positional(argv: Sequence[str]) -> dict:
    """Positional argv tier: ``[elements]`` or
    ``[tile_w tile_h [stencil_w stencil_h]]``."""
    args = [a for a in argv if not a.startswith("-")]
    out = {}
    if len(args) == 1:
        out["elements"] = int(args[0])
    elif len(args) >= 2:
        out["tile_width"] = int(args[0])
        out["tile_height"] = int(args[1])
        if len(args) >= 3:
            out["stencil_width"] = int(args[2])
        if len(args) >= 4:
            out["stencil_height"] = int(args[3])
    return out


def _parse_env(env: dict) -> dict:
    """Env tier: TPUSCRATCH_* variables (runtime discovery only)."""
    out = {}
    if "TPUSCRATCH_DTYPE" in env:
        out["dtype"] = env["TPUSCRATCH_DTYPE"]
    if "TPUSCRATCH_NO_LOG" in env:
        out["log"] = env["TPUSCRATCH_NO_LOG"] not in ("1", "true")
    if "TPUSCRATCH_MESH" in env:  # e.g. "2x4"
        out["mesh_shape"] = tuple(
            int(x) for x in env["TPUSCRATCH_MESH"].split("x")
        )
    if env.get("TPUSCRATCH_ABORT_ON_ERROR", "") in ("1", "true", "yes"):
        out["error_policy"] = ErrorPolicy.ABORT
    return out


def _parse_flags(argv: Sequence[str]) -> dict:
    """``--name=value`` pairs (dashes in names map to underscores)."""
    fields = {f.name: f for f in dataclasses.fields(Config)}
    out = {}
    for a in argv:
        if a.startswith("--"):
            if "=" not in a:
                # refuse the space-separated form rather than silently
                # dropping the flag and mis-parsing its value as a
                # positional argument
                raise ValueError(
                    f"flag {a} needs a value: use {a}=VALUE"
                )
            key, value = a[2:].split("=", 1)
            key = key.replace("-", "_")
            if key not in fields:
                raise ValueError(
                    f"unknown config flag --{key}; fields: {sorted(fields)}"
                )
            out[key] = _coerce(key, fields[key].default, value)
    return out
