"""The DMA-halo 2D stencil on one card (``csrc/halo_dma.cu``).

The twin of ``tpuscratch.ops.halo_dma``, with the same entry points and
refusals: ``run_stencil_dma`` (depth 1 with 5-point coefficients on the
ring kernel, anything else on the depth-k kernel) and
``run_stencil_dma_hbm`` (one launch per step). Each takes the stacked
padded tiles ``(rows, cols, ph, pw)`` of a periodic mesh and returns them
after ``steps`` updates, the halo re-wrapped by one trailing exchange, so
the result is interchangeable with the other impls'.

On the TPU every rank's ghost strips travel between chips by remote DMA.
Here every rank is a slice of one tensor on one card and the topology is
periodic, so the cores tile one torus and each kernel reads the
neighbouring rank's core where the TPU kernel waited for a strip. The
kernel wrappers work on the stacked cores ``(rows, cols, H, W)``:

- ``dma_ring``: ``steps`` 5-point steps in one cooperative launch;
- ``dma_deep``: one launch per round of ``depth`` substeps (5 or 9
  points), a shared-memory trapezoid over the neighbours' k-deep edges;
- ``dma_hbm_step``: one step per launch, 5 or 9 points.

On a CUDA tensor each launches its kernel (or raises); on a CPU tensor it
runs its plain torch version, the same steps on the assembled torus with
``torch.roll`` in the kernel's order of operations.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpuscratch_torch.halo.exchange import HaloSpec, halo_exchange
from tpuscratch_torch.halo.stencil import rebuild
from tpuscratch_torch.ops.common import (
    check_cuda,
    check_status,
    counters,
    library,
    route,
    smem_optin,
    stream_of,
    taps_args,
    trapezoid_tile,
)

Coeffs = tuple[float, float, float, float, float]
JACOBI: Coeffs = (0.25, 0.25, 0.25, 0.25, 0.0)

#: (dy, dx) per coefficient, in halo.stencil.nine_point coeff order
#: (n, s, w, e, nw, ne, sw, se, center).
_OFFS9 = (
    (-1, 0), (1, 0), (0, -1), (0, 1),
    (-1, -1), (-1, 1), (1, -1), (1, 1), (0, 0),
)

_P = ctypes.c_void_p
_I = ctypes.c_int


def as_nine(coeffs) -> tuple[float, ...]:
    """Normalize 5-point (n,s,w,e,c) to 9-point coeff order with zero
    diagonals; 9-tuples pass through."""
    c = tuple(float(x) for x in coeffs)
    if len(c) == 9:
        return c
    if len(c) == 5:
        return c[:4] + (0.0, 0.0, 0.0, 0.0) + c[4:]
    raise ValueError(f"coeffs must have 5 or 9 entries, got {len(c)}")


def ring_taps(coeffs) -> list:
    """The ring kernel's terms: n, s, w, e, c, zero coefficients included."""
    if len(coeffs) != 5:
        raise ValueError(f"the ring kernel takes 5-point coeffs, got {len(coeffs)}")
    return [(dy, dx, float(c)) for (dy, dx), c in zip(_OFFS9[:4] + _OFFS9[8:], coeffs)]


def deep_taps(coeffs9) -> list:
    """The depth-k kernel's terms: ``_OFFS9`` order, zero coefficients
    skipped."""
    return [(dy, dx, c) for (dy, dx), c in zip(_OFFS9, as_nine(coeffs9)) if c != 0.0]


def hbm_taps(coeffs9) -> list:
    """The HBM kernel's terms: n, s, w, e, c, then the four diagonals when
    any of them is nonzero."""
    c = as_nine(coeffs9)
    five = [(dy, dx, v) for (dy, dx), v in zip(_OFFS9[:4] + _OFFS9[8:], c[:4] + c[8:])]
    if not any(v != 0.0 for v in c[4:8]):
        return five
    return five + [(dy, dx, v) for (dy, dx), v in zip(_OFFS9[4:8], c[4:8])]


# ---------------------------------------------------------------------------
# plain versions: the steps on the assembled torus


def _torus(cores: torch.Tensor) -> torch.Tensor:
    """(R, C, H, W) cores -> the (R*H, C*W) grid they tile."""
    R, C, H, W = cores.shape
    return cores.permute(0, 2, 1, 3).reshape(R * H, C * W)


def _cores(world: torch.Tensor, R: int, C: int) -> torch.Tensor:
    H, W = world.shape[0] // R, world.shape[1] // C
    return world.reshape(R, H, C, W).permute(0, 2, 1, 3).contiguous()


def torus_step(a: torch.Tensor, taps) -> torch.Tensor:
    """One periodic step of the grid ``a``: the taps summed left to right."""
    acc = None
    for dy, dx, c in taps:
        term = c * torch.roll(a, shifts=(-dy, -dx), dims=(0, 1))
        acc = term if acc is None else acc + term
    return acc


def _plain_steps(cores: torch.Tensor, steps: int, taps) -> torch.Tensor:
    R, C = cores.shape[:2]
    a = _torus(cores)
    for _ in range(steps):
        a = torus_step(a, taps)
    return _cores(a, R, C)


def dma_ring_plain(cores: torch.Tensor, steps: int, coeffs: Coeffs = JACOBI) -> torch.Tensor:
    return _plain_steps(cores, steps, ring_taps(coeffs))


def dma_deep_plain(cores: torch.Tensor, steps: int, coeffs9, depth: int) -> torch.Tensor:
    """On a torus the trapezoid's values are those of the per-step update,
    so the depth does not change the result."""
    return _plain_steps(cores, steps, deep_taps(coeffs9))


def dma_hbm_step_plain(cores: torch.Tensor, coeffs9) -> torch.Tensor:
    return _plain_steps(cores, 1, hbm_taps(coeffs9))


# ---------------------------------------------------------------------------
# kernel wrappers


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = library("halo_dma")
    taps = [_I, _P, _P, _P]
    lib.ts_dma_ring.argtypes = [_P, _P, _P] + [_I] * 5 + taps + [_P]
    lib.ts_dma_deep.argtypes = [_P, _P] + [_I] * 6 + taps + [_P]
    lib.ts_dma_hbm_step.argtypes = [_P, _P] + [_I] * 4 + taps + [_P]
    for fn in (lib.ts_dma_ring, lib.ts_dma_deep, lib.ts_dma_hbm_step):
        fn.restype = _I
    return lib


def _check_cores(cores: torch.Tensor, name: str) -> None:
    if cores.ndim != 4:
        raise ValueError(f"{name}: want stacked cores (rows, cols, H, W), got {tuple(cores.shape)}")


def dma_ring(cores: torch.Tensor, steps: int, coeffs: Coeffs = JACOBI) -> torch.Tensor:
    """``steps`` periodic 5-point steps of the torus the stacked cores
    tile, in ONE cooperative launch (two ping-pong buffers, a grid-wide
    barrier per step). Returns fresh cores."""
    _check_cores(cores, "dma_ring")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    taps = ring_taps(coeffs)
    if not route(cores, "dma_ring"):
        return dma_ring_plain(cores, steps, coeffs)
    check_cuda(cores, "dma_ring", 4)
    bufs = (torch.empty_like(cores), torch.empty_like(cores))
    with torch.cuda.device(cores.device):
        check_status(_lib(), _lib().ts_dma_ring(
            cores.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(), *cores.shape,
            steps, *taps_args(taps), stream_of(cores),
        ), "dma_ring")
    dma_ring.launches += 1
    return bufs[(steps - 1) % 2]


def dma_deep(cores: torch.Tensor, steps: int, coeffs9, depth: int) -> torch.Tensor:
    """``steps`` periodic 5/9-point steps, ``depth`` substeps per launch
    (one round: the k-deep ghost zone read from the neighbour ranks' cores,
    the substeps run as a trapezoid in shared memory); the last round is
    shallower when ``steps % depth`` is nonzero. Returns fresh cores."""
    _check_cores(cores, "dma_deep")
    if steps < 1 or depth < 1:
        raise ValueError(f"steps and depth must be >= 1, got {steps}, {depth}")
    taps = deep_taps(coeffs9)
    if not route(cores, "dma_deep"):
        return dma_deep_plain(cores, steps, coeffs9, depth)
    check_cuda(cores, "dma_deep", 4)
    optin = smem_optin(_lib(), "dma_deep")
    args = taps_args(taps)
    src, left = cores, steps
    while left:
        k = min(depth, left)
        dst = torch.empty_like(cores)
        with torch.cuda.device(cores.device):
            check_status(_lib(), _lib().ts_dma_deep(
                src.data_ptr(), dst.data_ptr(), *cores.shape, k,
                trapezoid_tile(optin, k, "dma_deep"), *args, stream_of(cores),
            ), "dma_deep")
        dma_deep.launches += 1
        src, left = dst, left - k
    return src


def dma_hbm_step(cores: torch.Tensor, coeffs9) -> torch.Tensor:
    """One periodic 5/9-point step of the torus, out of place, in one
    launch. Returns fresh cores."""
    _check_cores(cores, "dma_hbm_step")
    taps = hbm_taps(coeffs9)
    if not route(cores, "dma_hbm_step"):
        return dma_hbm_step_plain(cores, coeffs9)
    check_cuda(cores, "dma_hbm_step", 4)
    out = torch.empty_like(cores)
    with torch.cuda.device(cores.device):
        check_status(_lib(), _lib().ts_dma_hbm_step(
            cores.data_ptr(), out.data_ptr(), *cores.shape, *taps_args(taps),
            stream_of(cores),
        ), "dma_hbm_step")
    dma_hbm_step.launches += 1
    return out


# ---------------------------------------------------------------------------
# entry points


def _core_of(tile: torch.Tensor, spec: HaloSpec) -> torch.Tensor:
    lay = spec.layout
    want = tuple(spec.topology.dims) + lay.padded_shape
    if tuple(tile.shape) != want:
        raise ValueError(f"tiles {tuple(tile.shape)} != stacked padded {want}")
    hy, hx = lay.halo_y, lay.halo_x
    return tile[..., hy : hy + lay.core_h, hx : hx + lay.core_w].contiguous()


def _run_stencil_dma_deep(tile, spec, steps, coeffs9, depth, vmem_limit_bytes):
    """Dispatch helper for the depth-k kernel (see run_stencil_dma);
    ``vmem_limit_bytes`` is the TPU's VMEM budget, accepted for its
    signature."""
    new_core = dma_deep(_core_of(tile, spec), steps, coeffs9, depth)
    return halo_exchange(rebuild(tile, new_core, spec.layout), spec)


def hbm_band(H: int, W: int, itemsize: int, budget_bytes: int, diag: bool = False) -> int:
    """The TPU kernel's row band: the largest 8-multiple divisor of ``H``
    whose VMEM footprint fits the budget, with >= 2 bands. The CUDA
    kernel takes no band; this is the JAX package's pure sizing rule,
    kept for its signature."""
    Wp = -(-W // 128) * 128
    Hp = -(-H // 128) * 128
    fixed = 6 * Hp * 128 + 32 * (Wp + Hp) + 16 * Wp + (4 * Hp * 128 if diag else 0)
    for d in range(H // 2, 7, -1):
        if H % d == 0 and d % 8 == 0 and (7 * d * W + fixed) * itemsize <= budget_bytes:
            return d
    raise ValueError(
        f"no 8-aligned band of H={H} gives >= 2 bands within "
        f"{budget_bytes >> 20} MB VMEM (need H >= 16 with 8 | H, and "
        "the kernel footprint to fit the budget)"
    )


def _check_periodic(spec: HaloSpec, coeffs, what: str) -> None:
    if not all(spec.topology.periodic):
        raise ValueError(
            f"{what} requires a periodic topology; use run_stencil or "
            "run_stencil_deep(impl='xla') for open boundaries"
        )
    if len(coeffs) == 9 and spec.neighbors != 8:
        raise ValueError(
            "9-point coeffs need a neighbors=8 HaloSpec: the trailing "
            "re-wrap must fill the corner ghosts the stencil reads"
        )


def run_stencil_dma_hbm(
    tile: torch.Tensor,
    spec: HaloSpec,
    steps: int,
    coeffs: Coeffs = JACOBI,
    band: int | None = None,
    vmem_limit_bytes: int = 100 << 20,
) -> torch.Tensor:
    """``steps`` periodic 5/9-point updates, one ``dma_hbm_step`` launch
    per step, then the trailing re-wrap. ``band`` and ``vmem_limit_bytes``
    size the TPU kernel's VMEM row bands and are accepted for its
    signature; the TPU's refusals of ``H % 8``, of bands that are not
    8-multiple divisors and of VMEM budgets are gone. Periodic topologies
    only, and 9-point coeffs need a ``neighbors=8`` spec."""
    _check_periodic(spec, coeffs, "the HBM-resident DMA stencil")
    coeffs9 = as_nine(coeffs)
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if band is not None and band < 1:
        raise ValueError(f"band must be >= 1, got {band}")
    core = _core_of(tile, spec)
    for _ in range(steps):
        core = dma_hbm_step(core, coeffs9)
    return halo_exchange(rebuild(tile, core, spec.layout), spec)


def run_stencil_dma(
    tile: torch.Tensor,
    spec: HaloSpec,
    steps: int,
    coeffs: Coeffs = JACOBI,
    depth: int = 1,
    vmem_limit_bytes: int = 100 << 20,
) -> torch.Tensor:
    """``steps`` stencil iterations of the stacked tiles, the halo read
    from the neighbour ranks' cores inside the kernel, then one ordinary
    exchange re-wraps the padded tiles. Depth 1 with 5-point coeffs runs
    the ring kernel (all steps in one launch); 9-point coeffs or
    ``depth > 1`` the depth-k kernel (``depth`` substeps per launch).
    ``vmem_limit_bytes`` is the TPU's VMEM budget, accepted for its
    signature (its refusals are gone). Kept: periodic topologies only,
    9-point coeffs need ``neighbors=8``, ``depth >= 1``, a core of at
    least ``max(3, depth)`` on both axes."""
    lay = spec.layout
    if lay.halo_y < 1 or lay.halo_x < 1:
        raise ValueError("stencil needs halo >= 1 on both axes")
    _check_periodic(spec, coeffs, "DMA halo stencil")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    if min(lay.core_h, lay.core_w) < max(3, depth):
        raise ValueError(
            f"core {lay.core_h}x{lay.core_w} too small: need >= "
            f"max(3, depth={depth}) on both axes"
        )
    if len(coeffs) == 9 or depth > 1:
        return _run_stencil_dma_deep(tile, spec, steps, as_nine(coeffs), depth,
                                     vmem_limit_bytes)
    new_core = dma_ring(_core_of(tile, spec), steps, tuple(coeffs))
    return halo_exchange(rebuild(tile, new_core, lay), spec)


#: Every kernel wrapper, in the order of the TPU kernel table.
WRAPPERS = (dma_ring, dma_deep, dma_hbm_step)
reset_launches, launch_counts = counters(WRAPPERS)
