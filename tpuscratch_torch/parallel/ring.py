"""The generic ring pipeline: rotate a payload, combine at every hop.

The twin of ``tpuscratch.parallel.ring``: ``carry_{i+1} = combine(carry_i,
payload from rank (me - i))``, the payload moving one ring hop between
combines, so after n hops every rank has combined every rank's payload
once while holding one block at a time. There the hops are one
``lax.scan``; here they are a Python loop over ``comm.p2p`` ppermutes on
the stacked mesh, differentiable like any torch op. Call inside
``run_spmd``.
"""

from __future__ import annotations

from typing import Any, Callable, TypeVar

from tpuscratch_torch.comm.p2p import ring_perm, send_tree
from tpuscratch_torch.comm.spmd import AxisName, axis_size

Carry = TypeVar("Carry")
Combine = Callable[[Carry, Any, int], Carry]


def ring_scan(combine: Combine, init_carry: Carry, payload, axis: AxisName,
              reverse: bool = False, return_payload: bool = True):
    """Run the rotate-and-combine pipeline over ``axis``.

    ``combine(carry, block, hop) -> carry`` sees, at hop i, the payload that
    started on rank ``(me - i) % n`` (``(me + i) % n`` when ``reverse``);
    ``payload`` is a tensor or a nest of dicts, lists and tuples of them.
    Returns (final_carry, payload home again), or with ``return_payload``
    False (final_carry, None), skipping the homeward rotation."""
    if return_payload:
        return ring_scan_rw(lambda c, b, i: (combine(c, b, i), b), init_carry, payload, axis,
                            reverse)
    n = axis_size(axis)
    perm = ring_perm(n, -1 if reverse else 1, periodic=True)
    carry, block = init_carry, payload
    for i in range(n - 1):
        carry = combine(carry, block, i)
        block = send_tree(block, axis, perm)
    return combine(carry, block, n - 1), None


def ring_scan_rw(combine: Callable[[Carry, Any, int], tuple[Carry, Any]], init_carry: Carry,
                 payload, axis: AxisName, reverse: bool = False):
    """Rotate-and-combine where the combine also updates the visiting
    payload, ``combine(carry, block, hop) -> (carry, block)``: after n hops
    the block is home carrying every rank's contribution (the shape of a
    ring backward pass). Returns (final_carry, homeward_payload)."""
    n = axis_size(axis)
    perm = ring_perm(n, -1 if reverse else 1, periodic=True)
    carry, block = init_carry, payload
    for i in range(n):
        carry, block = combine(carry, block, i)
        block = send_tree(block, axis, perm)
    return carry, block
