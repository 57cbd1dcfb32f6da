"""The slice-spec algebra: indexed, subarray, struct, hindexed composition.

The twin of ``tpuscratch.dtypes.specs``. Parity map (reference -> here):

- ``MPI_Type_indexed`` 2 blocks (len 4 @ disp 5, len 2 @ disp 12) of a
  16-float array (mpi7.cpp:36-41) -> ``IndexedSpec(((5, 4), (12, 2)))``;
  the receiver's "6 plain floats" is exactly ``pack``'s output.
- ``MPI_Type_create_subarray`` (stencil2D.h:210-228,
  mpi-complex-types.cpp:35) -> ``SubarraySpec(offsets, shape)``.
- ``MPI_Type_create_struct`` over Particle {4 float; 2 int} (mpi8.cpp:
  13-17, 53) -> ``StructSpec``: a dict of same-leading-dim tensors (struct
  of arrays) that the spec validates, splits and joins.
- ``MPI_Type_create_hindexed`` over subarrays of separately allocated
  arrays (mpi-complex-types.cpp:49, 88) -> ``HIndexedSpec``: (array index,
  spec) pairs packed into one payload.

A spec reads and writes its array's TRAILING dims (one for ``IndexedSpec``,
``len(shape)`` for ``SubarraySpec``); leading dims pass through, so on a
stacked tensor ``(*mesh, *local)`` one call packs every rank at once and
``pack -> comm.p2p.ppermute -> unpack`` runs inside ``run_spmd``. A payload
is ``(*lead, size)``. ``unpack`` returns a copy: it never writes into the
tensor it was given.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from tpuscratch_torch.comm.p2p import ppermute


def _check_payload(flat: torch.Tensor, size: int, lead: tuple = ()) -> None:
    """A payload is ``(*lead, size)``: slicing would clip a wrong-sized one
    silently, so it is refused, as MPI's typed receive would."""
    if tuple(flat.shape) != tuple(lead) + (size,):
        raise ValueError(f"payload shape {tuple(flat.shape)} != spec size "
                         f"{tuple(lead) + (size,)}")


@dataclasses.dataclass(frozen=True)
class IndexedSpec:
    """Blocks of a 1D array: ((start, length), ...) — MPI_Type_indexed."""

    blocks: tuple[tuple[int, int], ...]

    def __post_init__(self):
        object.__setattr__(self, "blocks", tuple((int(s), int(l)) for s, l in self.blocks))
        for start, length in self.blocks:
            if start < 0 or length <= 0:
                raise ValueError(f"bad block ({start}, {length})")

    @property
    def size(self) -> int:
        return sum(l for _, l in self.blocks)

    def pack(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x[..., s:s + l] for s, l in self.blocks], dim=-1)

    def unpack(self, flat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        _check_payload(flat, self.size, tuple(x.shape[:-1]))
        out = x.clone()
        pos = 0
        for start, length in self.blocks:
            out[..., start:start + length] = flat[..., pos:pos + length]
            pos += length
        return out


@dataclasses.dataclass(frozen=True)
class SubarraySpec:
    """A rectangular region of an N-D array — MPI_Type_create_subarray."""

    offsets: tuple[int, ...]
    shape: tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "offsets", tuple(int(o) for o in self.offsets))
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        if len(self.offsets) != len(self.shape):
            raise ValueError(f"rank mismatch {self.offsets} vs {self.shape}")
        if any(o < 0 for o in self.offsets) or any(s <= 0 for s in self.shape):
            raise ValueError(f"bad subarray {self.offsets}/{self.shape}")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def index(self) -> tuple:
        """Slices selecting the region from the trailing dims; leading dims
        (a stacked tile tensor's ``(rows, cols)``) pass through."""
        return (Ellipsis,) + tuple(
            slice(o, o + s) for o, s in zip(self.offsets, self.shape)
        )

    def region(self, x: torch.Tensor) -> torch.Tensor:
        """The subarray itself, in its N-D shape (a view of ``x``)."""
        return x[self.index]

    def pack(self, x: torch.Tensor) -> torch.Tensor:
        return self.region(x).reshape(*x.shape[:x.ndim - len(self.shape)], self.size)

    def unpack(self, flat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """A copy of ``x`` with the region replaced by ``flat``."""
        lead = tuple(x.shape[:x.ndim - len(self.shape)])
        _check_payload(flat, self.size, lead)
        out = x.clone()
        out[self.index] = flat.reshape(lead + self.shape)
        return out


@dataclasses.dataclass(frozen=True)
class StructSpec:
    """Records spread across a dict of tensors (struct-of-arrays layout).

    The reference's array-of-structs Particle buffer (mpi8.cpp:13-17) is a
    layout forced by C memory; here, as in the JAX package, each field is
    its own contiguous tensor. ``fields`` names them; all share leading
    dim = record count."""

    fields: tuple[str, ...]

    def validate(self, tree: dict) -> int:
        if set(tree.keys()) != set(self.fields):
            raise ValueError(f"fields {sorted(tree)} != spec {sorted(self.fields)}")
        counts = {k: tree[k].shape[0] for k in self.fields}
        n = next(iter(counts.values()))
        if any(c != n for c in counts.values()):
            raise ValueError(f"ragged record counts {counts}")
        return n

    def records(self, tree: dict, start: int, count: int) -> dict:
        """A contiguous run of records — e.g. one rank's scatter share."""
        n = self.validate(tree)
        if start < 0 or count < 0 or start + count > n:
            # lax.dynamic_slice clamps the start into range; so does this
            start = min(max(start, 0), max(n - count, 0))
        return {k: tree[k][start:start + count] for k in self.fields}

    def concat(self, trees: Sequence[dict]) -> dict:
        for t in trees:
            self.validate(t)
        return {k: torch.cat([t[k] for t in trees], dim=0) for k in self.fields}


@dataclasses.dataclass(frozen=True)
class HIndexedSpec:
    """Regions of several separately-allocated arrays in one message.

    ``parts[i] = (array_index, spec)``: which input array, and which region
    of it (mpi-complex-types: 3-element blocks of 3 separate arrays sent as
    one payload)."""

    parts: tuple[tuple[int, "IndexedSpec | SubarraySpec"], ...]

    def __post_init__(self):
        object.__setattr__(self, "parts", tuple(self.parts))

    @property
    def size(self) -> int:
        return sum(spec.size for _, spec in self.parts)

    def pack(self, arrays: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat([spec.pack(arrays[i]) for i, spec in self.parts], dim=-1)

    def unpack(self, flat: torch.Tensor, arrays: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        _check_payload(flat, self.size, tuple(flat.shape[:-1]))
        out = list(arrays)
        pos = 0
        for i, spec in self.parts:
            out[i] = spec.unpack(flat[..., pos:pos + spec.size], out[i])
            pos += spec.size
        return out


def exchange_packed(spec, x: torch.Tensor, axis, perm, dest_spec=None) -> torch.Tensor:
    """pack -> ppermute -> unpack inside ``run_spmd``: a structured region
    of every rank's value travels to the permutation's destination and
    lands in ``dest_spec``'s region there (default: the send region) — a
    committed datatype passed to Isend/Irecv on both sides. Ranks no pair
    sends to receive a zero payload, as ``lax.ppermute`` gives."""
    arrived = ppermute(spec.pack(x), axis, list(perm))
    return (dest_spec or spec).unpack(arrived, x)
