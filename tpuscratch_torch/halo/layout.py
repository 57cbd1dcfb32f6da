"""Tile layout and region geometry — pure functions, no devices.

A copy of ``tpuscratch.halo.layout``: ``TileLayout`` is a frozen value
object and all region math returns ``SubarraySpec`` values.

Geometry conventions (row-major, row 0 = top):
- A padded tile is ``(2*halo_y + core_h, 2*halo_x + core_w)``.
- The border partition: 4 edge strips of core width/height + 4 corners,
  which exactly tile the ghost border — each piece is filled by one
  neighbor, so 8 transfers cover everything (periodic corners included).
"""

from __future__ import annotations

import dataclasses
import enum

from tpuscratch_torch.dtypes import SubarraySpec
from tpuscratch_torch.runtime.topology import Direction


class Region(enum.Enum):
    """The 13-region taxonomy: 9 border/center pieces of a bordered
    rectangle plus 4 full-length strips."""

    CENTER = "center"
    TOP = "top"
    BOTTOM = "bottom"
    LEFT = "left"
    RIGHT = "right"
    TOP_LEFT = "top_left"
    TOP_RIGHT = "top_right"
    BOTTOM_LEFT = "bottom_left"
    BOTTOM_RIGHT = "bottom_right"
    TOP_STRIP = "top_strip"     # full width, corners included
    BOTTOM_STRIP = "bottom_strip"
    LEFT_STRIP = "left_strip"   # full height, corners included
    RIGHT_STRIP = "right_strip"


def sub_region(base: SubarraySpec, halo_y: int, halo_x: int, region: Region) -> SubarraySpec:
    """The rectangle of ``region`` within ``base``, for border thickness
    (halo_y, halo_x). Composable: apply to a grid to get its core
    (CENTER), then to the core to get its interior pieces."""
    oy, ox = base.offsets
    h, w = base.shape
    ih, iw = h - 2 * halo_y, w - 2 * halo_x  # interior extents
    if ih <= 0 or iw <= 0:
        raise ValueError(f"halo ({halo_y},{halo_x}) swallows base {base.shape}")

    rows = {
        "top": (oy, halo_y),
        "mid": (oy + halo_y, ih),
        "bot": (oy + h - halo_y, halo_y),
        "all": (oy, h),
    }
    cols = {
        "left": (ox, halo_x),
        "mid": (ox + halo_x, iw),
        "right": (ox + w - halo_x, halo_x),
        "all": (ox, w),
    }
    table = {
        Region.CENTER: ("mid", "mid"),
        Region.TOP: ("top", "mid"),
        Region.BOTTOM: ("bot", "mid"),
        Region.LEFT: ("mid", "left"),
        Region.RIGHT: ("mid", "right"),
        Region.TOP_LEFT: ("top", "left"),
        Region.TOP_RIGHT: ("top", "right"),
        Region.BOTTOM_LEFT: ("bot", "left"),
        Region.BOTTOM_RIGHT: ("bot", "right"),
        Region.TOP_STRIP: ("top", "all"),
        Region.BOTTOM_STRIP: ("bot", "all"),
        Region.LEFT_STRIP: ("all", "left"),
        Region.RIGHT_STRIP: ("all", "right"),
    }
    (ry, sh), (rx, sw) = (rows[table[region][0]], cols[table[region][1]])
    return SubarraySpec(offsets=(ry, rx), shape=(sh, sw))


_DIR_TO_REGION = {
    Direction.TOP: Region.TOP,
    Direction.BOTTOM: Region.BOTTOM,
    Direction.LEFT: Region.LEFT,
    Direction.RIGHT: Region.RIGHT,
    Direction.TOP_LEFT: Region.TOP_LEFT,
    Direction.TOP_RIGHT: Region.TOP_RIGHT,
    Direction.BOTTOM_LEFT: Region.BOTTOM_LEFT,
    Direction.BOTTOM_RIGHT: Region.BOTTOM_RIGHT,
}


@dataclasses.dataclass(frozen=True)
class TileLayout:
    """One rank's tile: core extent + ghost-border widths."""

    core_h: int
    core_w: int
    halo_y: int
    halo_x: int

    def __post_init__(self):
        if self.core_h <= 0 or self.core_w <= 0:
            raise ValueError(f"bad core {self.core_h}x{self.core_w}")
        if self.halo_y < 0 or self.halo_x < 0:
            raise ValueError(f"bad halo {self.halo_y},{self.halo_x}")
        if self.halo_y > self.core_h or self.halo_x > self.core_w:
            raise ValueError("halo deeper than core: neighbor strips overlap")

    @classmethod
    def for_stencil(cls, core_h: int, core_w: int, stencil_h: int, stencil_w: int) -> "TileLayout":
        """Ghost depth = stencil extent // 2."""
        return cls(core_h, core_w, stencil_h // 2, stencil_w // 2)

    @property
    def padded_shape(self) -> tuple[int, int]:
        return (self.core_h + 2 * self.halo_y, self.core_w + 2 * self.halo_x)

    @property
    def whole(self) -> SubarraySpec:
        return SubarraySpec((0, 0), self.padded_shape)

    @property
    def core(self) -> SubarraySpec:
        return sub_region(self.whole, self.halo_y, self.halo_x, Region.CENTER)

    def halo_region(self, d: Direction) -> SubarraySpec:
        """The ghost-border piece in direction ``d`` — the RECEIVE landing
        zone for data arriving from the ``d`` neighbor."""
        return sub_region(self.whole, self.halo_y, self.halo_x, _DIR_TO_REGION[d])

    def send_region(self, d: Direction) -> SubarraySpec:
        """The core strip adjacent to edge ``d`` — what travels TO the
        ``d`` neighbor (landing in their ``opposite(d)`` halo). Edge strips
        span the FULL core width/height, corners pair with corners."""
        dr, dc = d.offset
        oy, ox = self.halo_y, self.halo_x  # core origin in padded coords
        if dr < 0:
            ry, sh = oy, self.halo_y
        elif dr > 0:
            ry, sh = oy + self.core_h - self.halo_y, self.halo_y
        else:
            ry, sh = oy, self.core_h
        if dc < 0:
            rx, sw = ox, self.halo_x
        elif dc > 0:
            rx, sw = ox + self.core_w - self.halo_x, self.halo_x
        else:
            rx, sw = ox, self.core_w
        return SubarraySpec(offsets=(ry, rx), shape=(sh, sw))
