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
kernel of ``ops.attention``), the training paths (``ops.attention``'s
flash kernels, ``parallel.{ring,ring_attention,ulysses}``, ``ops.adam``,
``models.zero``, ``parallel.{plan,pipeline,ssm}``, ``models.ssm``), and
the solvers (``solvers``: CG and pipelined CG, 2D and 3D multigrid, whose
``jacobi-stream`` smoother runs the streamed 3D kernel, and the spectral
solvers over ``parallel.fft``, the pencil FFT; ``bench.fft_bench``,
``bench.mg3d_chip``), and the fault-tolerant chunked path (``runtime.
{checkpoint,async_ckpt,chunked}``, ``obs``, ``ft``, ``models.trainer``,
``halo.driver.checkpointed_stencil``, ``solvers.runner``), which runs
the existing kernels in checkpointed, resumable chunks, and above it the
co-scheduler (``runtime.scheduler``), the communication ledger
(``obs.ledger``), the regression gate and run report (``obs.regress``,
``obs.report``), profiling (``runtime.profiling``) and weak scaling
(``bench.weak_scaling``).
"""

__version__ = "0.1.0"
