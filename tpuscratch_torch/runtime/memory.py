"""Memory placement, staging and introspection -- the allocator layer.

The twin of ``tpuscratch.runtime.memory``. The reference's
``host_allocator.h`` allocates page-locked host memory with
``cudaMallocHost`` (host_allocator.h:72-83) so that staged transfers run
at full DMA speed; the pingpong PAGE_LOCKED ablation compares it with
pageable memory (mpi-pingpong-gpu-async.cpp:43-49). Here the three
memory spaces of the JAX package are:

- ``device``: a tensor on the card;
- ``pinned_host``: a page-locked CPU tensor (``pin_memory``);
- ``unpinned_host``: an ordinary, pageable CPU tensor.

``put`` moves a tensor between them; ``memory_kinds`` lists the spaces
``put`` reaches from a device. ``donate`` is jit donation's counterpart:
the wrapped function runs, then the donated inputs' storage is released
(manual buffer reuse, the other thing a CUDA allocator is for).
"""

from __future__ import annotations

import functools
import gc
from typing import Callable, Optional

import torch

from tpuscratch_torch.runtime.mesh import resolve_device

DEVICE = "device"
PINNED_HOST = "pinned_host"
UNPINNED_HOST = "unpinned_host"
KINDS = (DEVICE, PINNED_HOST, UNPINNED_HOST)


def memory_kinds(device=None) -> tuple[str, ...]:
    """The memory spaces ``put`` reaches from ``device`` (default the card,
    as ``resolve_device`` reads it): the device's own memory, page-locked
    host memory where a CUDA driver can pin it, and pageable host memory."""
    resolve_device(device)
    pinned = (PINNED_HOST,) if torch.cuda.is_available() else ()
    return (DEVICE,) + pinned + (UNPINNED_HOST,)


def supports_kind(kind: str, device=None) -> bool:
    return kind in memory_kinds(device)


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for item in tree for t in _tensors(item)]
    return []


def donate(fn: Callable, argnums=0) -> Callable:
    """``fn`` with donated inputs, the counterpart of ``jax.jit(fn,
    donate_argnums=argnums)``: the wrapper returns what ``fn`` returns,
    then releases the storage of every tensor in the donated arguments
    (``untyped_storage().resize_(0)``: a donated tensor afterwards holds no
    memory, as a donated JAX array is deleted; a tensor over memory torch
    does not own, such as a numpy array's, lets go of it instead). Storage that an output
    shares with a donated input (an in-place update, a view) is kept, so
    no output loses its data. Callers must not use donated tensors
    afterwards."""
    argnums = (argnums,) if isinstance(argnums, int) else tuple(argnums)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        kept = {t.untyped_storage().data_ptr() for t in _tensors(out)}
        for i in argnums:
            for t in _tensors(args[i]):
                st = t.untyped_storage()
                if not st.nbytes() or st.data_ptr() in kept:
                    continue
                if st.resizable():
                    st.resize_(0)
                else:  # memory torch does not own (numpy's): drop the reference
                    with torch.no_grad():
                        t.set_()
        return out

    return wrapper


def kind_of(x: torch.Tensor) -> str:
    if x.device.type != "cpu":
        return DEVICE
    return PINNED_HOST if x.is_pinned() else UNPINNED_HOST


def put(x: torch.Tensor, kind: str = DEVICE, device=None) -> torch.Tensor:
    """``x`` in memory space ``kind``: on the card (``device``, default the
    card ``x`` is on, else the current one), or in page-locked or pageable
    host memory. Shape and values are untouched."""
    if kind == DEVICE:
        target = x.device if device is None and x.device.type == "cuda" else resolve_device(device)
        return x.to(target)
    if kind == PINNED_HOST:
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return out.copy_(x)
    if kind == UNPINNED_HOST:
        out = torch.empty(x.shape, dtype=x.dtype)
        return out.copy_(x)
    raise ValueError(f"unknown memory kind {kind!r} (want one of {KINDS})")


def pin_to_host(x: torch.Tensor) -> torch.Tensor:
    """Stage ``x`` into page-locked host memory (cudaMallocHost analogue)."""
    return put(x, PINNED_HOST)


def to_device(x: torch.Tensor, device=None) -> torch.Tensor:
    """Bring ``x`` (back) to the card (``device`` as ``resolve_device``
    reads it; a CPU ``device`` keeps it in host memory)."""
    return put(x, DEVICE, device)


def host_roundtrip(x: torch.Tensor, pinned: bool = True) -> torch.Tensor:
    """Device -> host -> device staging pass, back onto ``x``'s device: the
    HOST_COPY / PAGE_LOCKED ablation pair (mpi-pingpong-gpu-async.cpp:
    59-70, 43-49); ``pinned`` selects page-locked vs pageable memory."""
    return to_device(put(x, PINNED_HOST if pinned else UNPINNED_HOST), x.device)


def live_bytes(device=None, kind: Optional[str] = None) -> int:
    """Bytes of the storages of live tensors on ``device`` (all devices if
    None), optionally of one memory kind: a census of what Python holds,
    for any device (``memory_stats`` is the card allocator's own view).
    Views of one storage count once."""
    want = None if device is None else torch.device(device)
    seen = {}
    for obj in gc.get_objects():
        try:
            if not issubclass(type(obj), torch.Tensor) or obj.is_meta:
                continue
            dev = obj.device
            if want is not None and (dev.type != want.type or (
                    want.index is not None and dev.index != want.index)):
                continue
            if kind is not None and kind_of(obj) != kind:
                continue
            st = obj.untyped_storage()
            seen[(str(dev), st.data_ptr())] = st.nbytes()
        except (ReferenceError, RuntimeError):  # tensor mid-deletion
            continue
    return sum(seen.values())


def memory_stats(device=None) -> dict:
    """The card allocator's statistics (``torch.cuda.memory_stats``) with
    ``bytes_in_use`` set to the bytes it holds for tensors; on the CPU a
    census of live tensors."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        stats = dict(torch.cuda.memory_stats(dev))
        stats["bytes_in_use"] = torch.cuda.memory_allocated(dev)
        return stats
    return {"bytes_in_use": live_bytes(dev), "source": "live_tensors_census"}
