"""Structured slice specs — MPI derived datatypes, functionally (the twin
of ``tpuscratch.dtypes``).

A spec is an immutable value with two functions: ``pack(arrays)`` -> the
flat payload, and ``unpack(flat, arrays)`` -> a copy of the arrays with the
payload written back. ``pack -> ppermute -> unpack`` inside ``run_spmd``
(``exchange_packed``) is committing a datatype and passing it to
Isend/Irecv; there is nothing to commit or free.
"""

from tpuscratch_torch.dtypes.specs import (  # noqa: F401
    HIndexedSpec,
    IndexedSpec,
    StructSpec,
    SubarraySpec,
    exchange_packed,
)
