"""The reference's programs on the port: twins of ``examples/ex01``-``ex10``
(the mpi1..mpi10 progression, the CUDA dot products, the stencil driver and
the pingpong benchmark). Each runs as ``python -m
tpuscratch_torch.examples.exNN_...`` on the card, or on the CPU when
``TPUSCRATCH_ON_CPU=1`` is set (``runtime.hostenv``); a mesh of 8 ranks is
stacked on the one device."""
