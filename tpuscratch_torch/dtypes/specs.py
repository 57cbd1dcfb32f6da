"""Rectangular sub-array specs (``MPI_Type_create_subarray``).

The one spec of ``tpuscratch.dtypes.specs`` the halo path needs. A region
is read by plain slicing; ``unpack`` writes by slice assignment into a
copy, so it never aliases the array it was given.
"""

from __future__ import annotations

import dataclasses
import math

import torch


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
        return self.region(x).reshape(-1)

    def unpack(self, flat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """A copy of ``x`` with the region replaced by ``flat``."""
        if flat.ndim != 1 or flat.shape[0] != self.size:
            raise ValueError(f"payload shape {tuple(flat.shape)} != spec size ({self.size},)")
        out = x.clone()
        out[self.index] = flat.reshape(self.shape)
        return out
