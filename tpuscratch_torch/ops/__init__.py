"""Hand-written CUDA kernels for Hopper and their wrappers (built at first launch).

The twin of ``tpuscratch.ops``: dot-product reductions (``reduction``),
device-side fills (``fill``) and the 2D stencil kernels
(``stencil_kernel``, ``stencil_stream``, ``halo_dma``).
"""

from tpuscratch_torch.ops.fill import fill, iota2d  # noqa: F401
from tpuscratch_torch.ops.reduction import dot, dot_full, dot_partials  # noqa: F401
