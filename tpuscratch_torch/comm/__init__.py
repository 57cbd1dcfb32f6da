"""Communication layer over the stacked mesh: named collectives and
point-to-point patterns (the twin of ``tpuscratch.comm``).

Mapping table (reference -> here), as in the JAX package:
- MPI_Reduce/Allreduce  -> ``allreduce_*`` / ``reduce_to_root``
- MPI_Gather/Allgather  -> ``gather_to_root`` / ``all_gather``
- MPI_Bcast             -> ``broadcast``
- MPI_Scatter           -> ``scatter_from_root``
- MPI_Isend/Irecv rings -> ``ring_shift`` / ``neighbor_exchange``
- MPI_Send/Recv pairs   -> ``send_pairs`` / ``pingpong``
- MPI_Scan/Exscan       -> ``prefix_sum``
- analytic wire bytes   -> ``count_wire_bytes`` (the ledger's formulas)
- sub-communicators     -> collectives over one axis of a multi-axis mesh

All ranks are slices of one tensor on one device; a ``torch.distributed``
backend across cards is not ported yet.
"""

from tpuscratch_torch.comm.collectives import (  # noqa: F401
    WireBytes,
    all_gather,
    all_to_all,
    allreduce_max,
    allreduce_min,
    allreduce_sum,
    broadcast,
    count_wire_bytes,
    gather_to_root,
    prefix_sum,
    reduce_scatter,
    reduce_to_root,
    scatter_from_root,
)
from tpuscratch_torch.comm.p2p import (  # noqa: F401
    neighbor_exchange,
    pingpong,
    ring_perm,
    ring_shift,
    send_pairs,
    token_ring,
)
from tpuscratch_torch.comm.spmd import P, PartitionSpec, run_spmd  # noqa: F401
