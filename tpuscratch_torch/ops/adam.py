"""The fused single-pass Adam update (``csrc/adam.cu``).

The twin of ``tpuscratch.ops.adam``: one kernel reads (w, g, m, v) and
writes (w', m', v') an element, the 7-access (28 B with float32 moments, 20
with bfloat16) floor of the optimizer step. w and g are float32; m and v
are float32 or bfloat16 storage, summed in float32; w' comes from the
unrounded moments.

- ``fused_adam_flat(w, g, m, v, alpha)``: one launch over tensors of any
  shape. ``alpha`` (the bias-corrected step size) is a float32 tensor
  whose shape is a prefix of ``w``'s, one value per leading index (the
  stacked ranks of a mesh, ``models.transformer.adam_alpha``'s
  ``(*mesh)``), or a number. The rows under the leading dims must each be
  contiguous; the leading dims may be strided. The TPU kernel's
  ``(rows, 1024)`` layout and its padding are not needed.
- ``fused_adam_tree``: one ``fused_adam_flat`` a leaf of a parameter tree
  (nested dicts and lists), as the JAX package launches one kernel a leaf.
- ``fused_adam_plain``: the kernel's arithmetic in torch ops, the CPU path
  and the card-side reference.

``donate=True`` is the torch counterpart of the JAX donation: w, m and v
are updated in place and returned (the outputs alias the inputs; the
optimizer never holds two copies of a moment). ``donate=False`` returns new
tensors and leaves the inputs alone. Autograd is not involved: the train
steps differentiate detached copies, so writing the parameters after the
gradient is safe.

A CUDA tensor launches the kernel (built at first use) or raises; a CPU
tensor takes the plain version. The wrapper counts its launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from tpuscratch_torch.ops.common import check_status, counters, library, route, stream_of

MOMENT_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = library("adam")
    p = ctypes.c_void_p
    f = ctypes.c_float
    lib.ts_fused_adam.argtypes = [p, p, p, p, p, p, p, p, ctypes.c_longlong, ctypes.c_longlong,
                                  ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                                  f, f, f, f, f, p]
    lib.ts_fused_adam.restype = ctypes.c_int
    return lib


def _alpha(alpha, w: torch.Tensor) -> torch.Tensor:
    """``alpha`` as a float32 tensor on ``w``'s device whose shape is a
    prefix of ``w``'s (a number becomes a 0-dim tensor)."""
    a = torch.as_tensor(alpha, dtype=torch.float32, device=w.device)
    if tuple(a.shape) != tuple(w.shape[:a.ndim]):
        raise ValueError(f"alpha {tuple(a.shape)} is not a leading prefix of the operand "
                         f"{tuple(w.shape)}: one value per leading index")
    return a


def fused_adam_plain(w, g, m, v, alpha, b1: float = 0.9, b2: float = 0.999,
                     eps: float = 1e-8):
    """The kernel's arithmetic in torch ops: (w', m', v'), new tensors, m'
    and v' in the moments' dtype."""
    a = _alpha(alpha, w)
    a = a.reshape(*a.shape, *(1,) * (w.ndim - a.ndim))
    g = g.float()
    m2 = b1 * m.float() + (1.0 - b1) * g
    v2 = b2 * v.float() + (1.0 - b2) * g * g
    w2 = w - a * m2 / (torch.sqrt(v2) + eps)
    return w2, m2.to(m.dtype), v2.to(v.dtype)


def _row_stride(t: torch.Tensor, lead: int) -> int | None:
    """The element stride between the rows of ``t`` seen as
    (prod(shape[:lead]), prod(shape[lead:])), or None where the kernel cannot
    walk it so: the trailing dims must be contiguous and the leading dims
    must collapse to one stride."""
    trail = math.prod(t.shape[lead:])
    if t.numel() == 0:
        return trail
    if not t[(0,) * lead].is_contiguous():
        return None
    dims = [d for d in range(lead) if t.shape[d] != 1]
    if not dims:
        return trail
    row = expect = t.stride(dims[-1])
    for d in reversed(dims):
        if t.stride(d) != expect:
            return None
        expect *= t.shape[d]
    return row


def writable_rows(t: torch.Tensor, lead: int) -> bool:
    """Whether the kernel can update ``t`` in place with ``lead`` leading
    dims: rows it can walk, no two of which overlap (an expanded copy axis
    has stride 0)."""
    row = _row_stride(t, lead)
    return row is not None and (row >= math.prod(t.shape[lead:]) or
                                math.prod(t.shape[:lead]) == 1)


def _check(w, g, m, v) -> None:
    for name, t in (("g", g), ("m", m), ("v", v)):
        if t.shape != w.shape or t.device != w.device:
            raise ValueError(f"fused_adam_flat: {name} {tuple(t.shape)} on {t.device} does "
                             f"not match w {tuple(w.shape)} on {w.device}")
    if w.dtype != torch.float32:
        raise TypeError(f"fused_adam_flat: w must be float32, got {w.dtype}")
    if m.dtype not in MOMENT_DTYPES or v.dtype != m.dtype:
        raise TypeError(f"fused_adam_flat: moments must be float32 or bfloat16 (one dtype), "
                        f"got {m.dtype} and {v.dtype}")


def fused_adam_flat(w, g, m, v, alpha, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                    donate: bool = True):
    """One fused pass: (w', m', v'). ``donate=True`` (default, as in the JAX
    package) writes them into w, m and v and returns those tensors."""
    g = g.float()
    _check(w, g, m, v)
    a = _alpha(alpha, w)
    if not route(w, "fused_adam_flat"):
        w2, m2, v2 = fused_adam_plain(w, g, m, v, a, b1, b2, eps)
        if donate:
            return w.copy_(w2), m.copy_(m2), v.copy_(v2)
        return w2, m2, v2
    lead = a.ndim
    rows = math.prod(w.shape[:lead])
    length = math.prod(w.shape[lead:])
    if donate:
        for name, t in (("w", w), ("m", m), ("v", v)):
            if not writable_rows(t, lead):
                raise ValueError(f"fused_adam_flat: {name} {tuple(t.shape)} strides "
                                 f"{tuple(t.stride())} cannot be updated in place")
        nw, nm, nv = w, m, v
    else:  # a read-only operand the kernel cannot walk is copied first
        w, m, v = (t if _row_stride(t, lead) is not None else t.contiguous() for t in (w, m, v))
        nw, nm, nv = (torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (w, m, v))
    if _row_stride(g, lead) is None:
        g = g.contiguous()
    strides = [_row_stride(t, lead) for t in (w, g, m, v, nw, nm, nv)]
    a = a.contiguous()
    lib = _lib()
    with torch.cuda.device(w.device):
        check_status(lib, lib.ts_fused_adam(
            w.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), nw.data_ptr(),
            nm.data_ptr(), nv.data_ptr(), a.data_ptr(), rows, length,
            (ctypes.c_longlong * 7)(*strides), int(m.dtype == torch.bfloat16),
            b1, 1.0 - b1, b2, 1.0 - b2, eps, stream_of(w)), "fused_adam_flat")
    fused_adam_flat.launches += 1
    return nw, nm, nv


def _zip_map(f, *trees):
    """``f(*leaves)`` (a 3-tuple) over matching trees of nested dicts and
    lists; returns three trees shaped like the first."""
    first = trees[0]
    if isinstance(first, dict):
        outs = {k: _zip_map(f, *(t[k] for t in trees)) for k in first}
        return tuple({k: o[i] for k, o in outs.items()} for i in range(3))
    if isinstance(first, (list, tuple)):
        outs = [_zip_map(f, *(t[i] for t in trees)) for i in range(len(first))]
        return tuple(type(first)(o[i] for o in outs) for i in range(3))
    return f(*trees)


def fused_adam_tree(params, grads, mu, nu, alpha, b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-8, donate: bool = False):
    """Per-leaf fused Adam over matching trees: (new_params, new_mu, new_nu).
    ``alpha`` is shared by every leaf (a number, a 0-dim tensor, or one value
    per leading index of every leaf). ``donate=True`` updates every leaf in
    place."""
    return _zip_map(lambda w, g, m, v: fused_adam_flat(w, g, m, v, alpha, b1, b2, eps,
                                                       donate=donate),
                    params, grads, mu, nu)


#: Every kernel wrapper, in the order of the TPU kernel table.
WRAPPERS = (fused_adam_flat,)
reset_launches, launch_counts = counters(WRAPPERS)
