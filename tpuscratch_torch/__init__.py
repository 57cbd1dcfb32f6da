"""tpuscratch_torch — ``tpuscratch`` on PyTorch and CUDA, for one NVIDIA H100.

A second package beside the JAX one, with the same module paths and
public names. Plain tensor code is PyTorch; every Pallas TPU kernel of
``tpuscratch`` becomes a kernel written by hand for Hopper (``csrc/``),
built with ``nvcc`` at its first launch and loaded with ``ctypes``.
Importing the package builds nothing and needs neither a card nor a CUDA
toolchain. Entry points run on the card unless the caller passes
``device="cpu"``, which runs every kernel's plain torch version.

Ported so far: the 2D halo-stencil path (``runtime``, ``dtypes``,
``halo``, ``ops.stencil_kernel``, ``bench``), and the distributed dot
product with the comm layer under it (``comm``, ``runtime.context``,
``runtime.memory``, ``ops.reduction``, ``ops.fill``, ``bench.dot_bench``,
``bench.pingpong``, ``bench.record``), the streamed and DMA-halo 2D
stencil (``ops.stencil_stream``, ``ops.halo_dma``), the 3D halo and
7/27-point stencil (``halo.halo3d``, with the 3D kernels of
``ops.stencil_kernel`` and ``ops.stencil_stream``), and the serving path's
default (``serve``, ``parallel.expert``, ``parallel.scores``,
``models.transformer``, ``bench.decode_bench``, with the paged-attention
kernel of ``ops.attention``).
"""

__version__ = "0.1.0"
