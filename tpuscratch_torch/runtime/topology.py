"""Process-grid topology as a pure value object.

A copy of ``tpuscratch.runtime.topology`` (the JAX package's module is
JAX-free, but this package imports nothing of it): an immutable, hashable
cartesian grid whose rank<->coords math is pure Python and whose neighbor
tables drive the stacked-tile halo exchange (``halo.exchange``).

Conventions:
- Coordinates are row-major: ``rank = coords[0]*dims[1]*... + ...``, the
  same flat order as the leading ``(rows, cols)`` dims of a stacked tile
  tensor, so topology rank == flat tile index.
- 2D coordinate order is ``(row, col)``; row 0 is the TOP of the grid,
  col 0 is the LEFT.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Iterator, Optional, Sequence


class Direction(enum.Enum):
    """The 8-neighborhood of a 2D grid cell, as (drow, dcol) offsets.
    TOP means "the neighbor above me" (row - 1)."""

    TOP = (-1, 0)
    BOTTOM = (1, 0)
    LEFT = (0, -1)
    RIGHT = (0, 1)
    TOP_LEFT = (-1, -1)
    TOP_RIGHT = (-1, 1)
    BOTTOM_LEFT = (1, -1)
    BOTTOM_RIGHT = (1, 1)

    @property
    def offset(self) -> tuple[int, int]:
        return self.value

    @property
    def opposite(self) -> "Direction":
        dr, dc = self.value
        return Direction((-dr, -dc))

    @property
    def is_diagonal(self) -> bool:
        dr, dc = self.value
        return dr != 0 and dc != 0


# Stable iteration order used when building exchange plans: edges then corners.
ALL_DIRECTIONS: tuple[Direction, ...] = (
    Direction.TOP,
    Direction.BOTTOM,
    Direction.LEFT,
    Direction.RIGHT,
    Direction.TOP_LEFT,
    Direction.TOP_RIGHT,
    Direction.BOTTOM_LEFT,
    Direction.BOTTOM_RIGHT,
)


@dataclasses.dataclass(frozen=True)
class CartTopology:
    """An N-dimensional cartesian process grid with optional periodic axes.

    ``dims`` is the grid shape; ``periodic[i]`` enables wraparound on axis i.
    """

    dims: tuple[int, ...]
    periodic: tuple[bool, ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "dims", tuple(self.dims))
        if not self.dims or any(d <= 0 for d in self.dims):
            raise ValueError(f"invalid grid dims {self.dims!r}")
        per = self.periodic or tuple(False for _ in self.dims)
        if len(per) != len(self.dims):
            raise ValueError(
                f"periodic {self.periodic!r} does not match dims {self.dims!r}"
            )
        object.__setattr__(self, "periodic", tuple(bool(p) for p in per))

    @property
    def ndim(self) -> int:
        return len(self.dims)

    @property
    def size(self) -> int:
        return math.prod(self.dims)

    def ranks(self) -> Iterator[int]:
        return iter(range(self.size))

    def coords(self, rank: int) -> tuple[int, ...]:
        """Row-major rank -> coordinates (MPI_Cart_coords equivalent)."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} out of range for grid {self.dims}")
        out = []
        for extent in reversed(self.dims):
            out.append(rank % extent)
            rank //= extent
        return tuple(reversed(out))

    def rank_at(self, coords: Sequence[int]) -> Optional[int]:
        """Coordinates -> rank, applying periodic wrap (MPI_Cart_rank).
        None when coords fall off a non-periodic axis (MPI_PROC_NULL)."""
        if len(coords) != self.ndim:
            raise ValueError(f"coords {coords!r} do not match dims {self.dims!r}")
        rank = 0
        for c, extent, per in zip(coords, self.dims, self.periodic):
            if not 0 <= c < extent:
                if not per:
                    return None
                c %= extent
            rank = rank * extent + c
        return rank

    def neighbor(self, rank: int, offset: Sequence[int] | Direction) -> Optional[int]:
        """Rank at ``coords(rank) + offset`` or None off an open boundary."""
        if isinstance(offset, Direction):
            offset = offset.offset
        here = self.coords(rank)
        return self.rank_at(tuple(c + d for c, d in zip(here, offset)))

    def shift(self, rank: int, axis: int, disp: int = 1) -> tuple[Optional[int], Optional[int]]:
        """(source, dest) ranks for a displacement along one axis
        (MPI_Cart_shift semantics; open boundaries yield None)."""
        off = [0] * self.ndim
        off[axis] = disp
        dest = self.neighbor(rank, off)
        off[axis] = -disp
        source = self.neighbor(rank, off)
        return source, dest

    def neighbors8(self, rank: int) -> dict[Direction, Optional[int]]:
        """All 8 neighbors of a rank on a 2D grid."""
        self._require_2d()
        return {d: self.neighbor(rank, d) for d in ALL_DIRECTIONS}

    def send_permutation(self, offset: Sequence[int] | Direction) -> list[tuple[int, int]]:
        """(src, dst) pairs where every rank sends to its ``offset`` neighbor.

        Diagonal offsets produce a single diagonal permutation. Ranks whose
        neighbor falls off an open boundary do not appear as sources.
        """
        pairs = []
        for r in self.ranks():
            n = self.neighbor(r, offset)
            if n is not None:
                pairs.append((r, n))
        return pairs

    def ring_permutation(self, axis: int = 0, disp: int = 1) -> list[tuple[int, int]]:
        """Permutation shifting every rank by ``disp`` along ``axis``."""
        off = [0] * self.ndim
        off[axis] = disp
        return self.send_permutation(off)

    def grid_string(self) -> str:
        """Rank map, one grid row per line."""
        self._require_2d()
        rows, cols = self.dims
        width = len(str(self.size - 1))
        lines = []
        for r in range(rows):
            lines.append(" ".join(f"{self.rank_at((r, c)):>{width}}" for c in range(cols)))
        return "\n".join(lines)

    def _require_2d(self) -> None:
        if self.ndim != 2:
            raise ValueError(f"operation requires a 2D grid, got dims {self.dims}")


def factor2d(n: int) -> tuple[int, int]:
    """Most-square (rows, cols) factorization of n, rows <= cols."""
    best = (1, n)
    for rows in range(1, math.isqrt(n) + 1):
        if n % rows == 0:
            best = (rows, n // rows)
    return best
