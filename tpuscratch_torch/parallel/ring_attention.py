"""Ring attention: exact attention over a sequence split around a ring.

The twin of ``tpuscratch.parallel.ring_attention``. Each rank holds one
block of the sequence: Q stays, the (K, V) block rotates around the mesh
axis (``parallel.ring.ring_scan``), and every hop folds the visiting block
into a running online-softmax state, so the full score matrix never
exists. Causal masking is on global positions: rank r's rows are
``[r*S, (r+1)*S)``, the block visiting at hop i came from rank
``(r - i) % n``.

Tensors are stacked: q, k, v ``(*mesh, *batch, S, H, D)``, so the ranks'
offsets ride as per-entry tensors and one kernel launch serves every rank
and batch row.
"""

from __future__ import annotations

import torch

from tpuscratch_torch.comm.p2p import ring_perm, send_tree
from tpuscratch_torch.comm.spmd import AxisName, axis_index, axis_size, current_mesh, mesh_context
from tpuscratch_torch.parallel.ring import ring_scan
from tpuscratch_torch.parallel.scores import NEG_INF, masked_scores


def _rank(axis: AxisName, like: torch.Tensor) -> torch.Tensor:
    """Each rank's index along ``axis``, shaped to broadcast against the
    leading (mesh and batch) dims of a ``(*mesh, *batch, S, H, D)`` tensor."""
    me = axis_index(axis)
    return me.reshape(me.shape + (1,) * (like.ndim - 3 - me.ndim))


def _state(q: torch.Tensor):
    """The empty online-softmax state: m (NEG_INF), l (0) ``(..., H, S)`` and
    the f32 weighted sum ``(..., S, H, D)``."""
    lead, (S, H, _) = q.shape[:-3], q.shape[-3:]
    m = torch.full(lead + (H, S), NEG_INF, dtype=torch.float32, device=q.device)
    return m, torch.zeros_like(m), torch.zeros(q.shape, dtype=torch.float32, device=q.device)


def _heads_last(x: torch.Tensor) -> torch.Tensor:
    """``(..., H, S)`` -> ``(..., S, H, 1)``, to scale an ``(..., S, H, D)`` sum."""
    return x.transpose(-1, -2)[..., None]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis: AxisName,
                   causal: bool = False, impl: str = "xla") -> torch.Tensor:
    """Exact multi-head attention, sequence split over ``axis``: q, k, v
    ``(*mesh, *batch, S, H, D)`` (this rank's block of a global ``n*S``
    sequence) -> this rank's ``(*mesh, *batch, S, H, D)`` block of the
    output. Call inside ``run_spmd``.

    ``impl``: "xla" forms each hop's scores densely in f32 torch ops;
    "pallas" runs the flash kernels a hop (``ops.attention``,
    ``return_state=True``) and merges the hops' (acc, m, l) exactly. The
    pallas path is trainable through its own backward: a second KV rotation
    that runs the flash backward kernels against the global log-sum-exp and
    carries each block's dk/dv home."""
    if q.ndim < 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"expected equal (S,H,D) blocks, got {tuple(q.shape)}/"
                         f"{tuple(k.shape)}/{tuple(v.shape)}")
    if impl == "pallas":
        return _RingFlash.apply(q, k, v, axis, causal)
    if impl != "xla":
        raise ValueError(f"unknown ring attention impl {impl!r}")
    S = q.shape[-3]
    n = axis_size(axis)
    me = _rank(axis, q)
    q32 = q.float()
    pos = torch.arange(S, device=q.device)
    rows = me[..., None] * S + pos                                    # (..., S)

    def combine_xla(state, kv_block, hop):
        m, l, o = state
        kb, vb = kv_block
        if causal:
            cols = ((me - hop) % n)[..., None] * S + pos
            mask = (rows[..., :, None] >= cols[..., None, :])[..., None, :, :]
        else:
            mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
        s = masked_scores(q32, kb, mask)                              # (..., H, S, T)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        # the guard: masked entries of a row masked so far would count as 1
        p = torch.where(s > NEG_INF * 0.5, p, torch.zeros((), device=p.device))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("...hst,...thd->...shd", p, vb.float())
        return m_new, l, o * _heads_last(corr) + pv

    (m, l, o), _ = ring_scan(combine_xla, _state(q), (k, v), axis, return_payload=False)
    return (o / _heads_last(l)).to(q.dtype)


def _ring_flash_forward(q, k, v, axis, causal):
    """Flash-kernel hops and the exact softmax merge: (out ``(..., S, H,
    D)``, m, l ``(..., H, S)``, l clamped at 1e-30)."""
    from tpuscratch_torch.ops.attention import flash_attention

    S = q.shape[-3]
    n = axis_size(axis)
    me = _rank(axis, q)

    def combine(state, kv_block, hop):
        m, l, o = state
        kb, vb = kv_block
        acc_i, m_i, l_i = flash_attention(q, kb, vb, causal=causal, q_offset=me * S,
                                          kv_offset=((me - hop) % n) * S, return_state=True)
        m_new = torch.maximum(m, m_i)
        c_old, c_new = torch.exp(m - m_new), torch.exp(m_i - m_new)
        return (m_new, l * c_old + l_i * c_new,
                o * _heads_last(c_old) + acc_i * _heads_last(c_new))

    (m, l, o), _ = ring_scan(combine, _state(q), (k, v), axis, return_payload=False)
    l_safe = torch.clamp_min(l, 1e-30)
    return (o / _heads_last(l_safe)).to(q.dtype), m, l_safe


class _RingFlash(torch.autograd.Function):
    """The pallas ring with the standard ring-attention backward: rotate the
    KV blocks with f32 gradient accumulators; every hop runs the flash
    backward kernels (``_flash_bwd_call``, f32 partials) against the saved
    global lse, adds dq locally and dk/dv onto the visiting block. dk/dv
    make the full n hops home; the spent k/v blocks stop one hop early."""

    @staticmethod
    def forward(ctx, q, k, v, axis, causal):
        out, m, l = _ring_flash_forward(q, k, v, axis, causal)
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.axis, ctx.causal, ctx.mesh = axis, causal, current_mesh()
        return out

    @staticmethod
    def backward(ctx, do):
        from tpuscratch_torch.ops.attention import _delta, _flash_bwd_call

        q, k, v, out, lse = ctx.saved_tensors
        with mesh_context(ctx.mesh):
            S = q.shape[-3]
            n = axis_size(ctx.axis)
            me = _rank(ctx.axis, q)
            dof = do.float()
            delta = _delta(dof, out)
            perm = ring_perm(n, 1, periodic=True)

            def contrib(dq, kb, vb, dk, dv, hop):
                dq_c, dk_c, dv_c = _flash_bwd_call(q, kb, vb, dof, lse, delta, me * S,
                                                   ((me - hop) % n) * S, ctx.causal,
                                                   out_dtype=torch.float32)
                return dq + dq_c, dk + dk_c, dv + dv_c

            zero = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
            dq, kb, vb, dk, dv = zero, k, v, zero, zero
            for i in range(n - 1):
                dq, dk, dv = contrib(dq, kb, vb, dk, dv, i)
                kb, vb, dk, dv = send_tree((kb, vb, dk, dv), ctx.axis, perm)
            dq, dk, dv = contrib(dq, kb, vb, dk, dv, n - 1)
            dk, dv = send_tree((dk, dv), ctx.axis, perm)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None
