"""2D and 3D (``halo3d``) domain decomposition with ghost-cell (halo) exchange on a
stacked-tile mesh."""

from tpuscratch_torch.halo.layout import Region, TileLayout, sub_region  # noqa: F401
from tpuscratch_torch.halo.exchange import HaloSpec, halo_exchange  # noqa: F401
from tpuscratch_torch.halo.stencil import five_point, nine_point, stencil_step  # noqa: F401
