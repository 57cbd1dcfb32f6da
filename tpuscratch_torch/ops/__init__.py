"""Hand-written CUDA kernels for Hopper and their wrappers (built at first launch).

The twin of ``tpuscratch.ops``: dot-product reductions (``reduction``),
device-side fills (``fill``), the one-step 2D and 3D stencil kernels
(``stencil_kernel``), the streamed 2D and 3D kernels (``stencil_stream``),
the DMA-halo kernels (``halo_dma``) and paged decode attention
(``attention``).
"""

from tpuscratch_torch.ops.fill import fill, iota2d  # noqa: F401
from tpuscratch_torch.ops.reduction import dot, dot_full, dot_partials  # noqa: F401
from tpuscratch_torch.ops.stencil_kernel import (  # noqa: F401
    seven_point_assembled_pallas,
    seven_point_banded_pallas,
    seven_point_strips_pallas,
)
from tpuscratch_torch.ops.stencil_stream import (  # noqa: F401
    nine_point_streamed_2d,
    seven_point_streamed_pallas,
)
