"""Distributed solvers built from the framework's primitives.

The twin of ``tpuscratch.solvers``: a conjugate-gradient Poisson solver
whose matvec is the halo-exchanged 5-point operator and whose inner
products are allreduced per-rank sums (``cg``; ``pipelined_cg`` folds an
iteration's scalars into one allreduce), its spectral sibling over the
pencil FFT (``spectral``), and geometric multigrid in 2D and 3D, whose 3D
``jacobi-stream`` smoother runs the streamed 3D kernel
(``multigrid3d``). The JAX package's ``solvers.runner`` (the checkpointed,
supervised 3D solve) is not ported: it needs the runtime, obs and ft
layers.
"""

from tpuscratch_torch.solvers.cg import (
    cg,
    dirichlet_laplacian,
    pipelined_cg,
    poisson_solve,
)
from tpuscratch_torch.solvers.multigrid import (
    mg_poisson_solve,
    pcg_poisson_solve,
    v_cycle,
)
from tpuscratch_torch.solvers.multigrid3d import (
    mg_poisson3d_solve,
    pcg_poisson3d_solve,
    v_cycle3,
)
from tpuscratch_torch.solvers.spectral import (
    periodic_poisson3d_fft,
    periodic_poisson_fft,
)

__all__ = [
    "cg",
    "pipelined_cg",
    "dirichlet_laplacian",
    "poisson_solve",
    "mg_poisson_solve",
    "mg_poisson3d_solve",
    "pcg_poisson_solve",
    "pcg_poisson3d_solve",
    "v_cycle",
    "v_cycle3",
    "periodic_poisson3d_fft",
    "periodic_poisson_fft",
]
