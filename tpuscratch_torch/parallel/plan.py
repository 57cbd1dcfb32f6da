"""One ShardingPlan for dp x sp x pp (x ep): the tree -> mesh-axes layer.

The twin of ``tpuscratch.parallel.plan``. A plan names the mesh axes once
-- data parallel (``dp``), sequence parallel (``sp``), pipeline stages
(``pp``), experts (``ep``, riding the dp axis in the EP-groups == DP-groups
layout) -- and the step builders (``models.zero.train_step_plan``, the
train benches) take the plan instead of a hardcoded dp x sp mesh. Axes are
checked against the mesh at construction, so a plan naming an axis the
mesh lacks fails here with the axis named.

The plan also carries the overlap policy of the ZeRO sync legs:
``overlap=True`` cuts the flat reduce-scatter, the update and the trailing
all-gather into ``prefetch_blocks`` block chains (``models.zero``), at the
same wire bytes. On the stacked mesh the chains run in order on one
stream: the schedule changes the collective count, not what overlaps.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from tpuscratch_torch.comm.spmd import P, run_spmd
from tpuscratch_torch.runtime.mesh import StackedMesh

__all__ = ["ShardingPlan"]

#: the logical axis roles a plan can map onto mesh axes
_LOGICAL = ("dp", "sp", "pp", "ep")


def _map_with_path(f, tree, path=()):
    """``f(path, leaf)`` over nested dicts, lists and tuples; a path is the
    tuple of dict keys and list indices down to the leaf."""
    if isinstance(tree, dict):
        return {k: _map_with_path(f, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(f, v, path + (i,)) for i, v in enumerate(tree))
    return f(path, tree)


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """Tree-path -> mesh-axes mapping with named axes dp/sp/pp(/ep).

    ``dp``/``sp``/``pp``/``ep`` are mesh axis names; ``pp`` and ``ep`` are
    optional, and ``ep`` defaults to the dp axis. ``n_micro`` is the GPipe
    microbatch count a step when a pp axis is in play; ``overlap`` turns the
    block decomposition of the sync legs on (``prefetch_blocks`` chains),
    off keeps the serial reduce-scatter -> update -> all-gather."""

    mesh: StackedMesh
    dp: str = "dp"
    sp: str = "sp"
    pp: Optional[str] = None
    ep: Optional[str] = None
    n_micro: int = 1
    overlap: bool = True
    prefetch_blocks: int = 4

    def __post_init__(self):
        named = {"dp": self.dp, "sp": self.sp, "pp": self.pp, "ep": self.ep}
        axis_names = tuple(self.mesh.axis_names)
        for logical in _LOGICAL:
            name = named[logical]
            if name is not None and name not in axis_names:
                raise ValueError(
                    f"ShardingPlan {logical}={name!r} is not an axis of the mesh (axes: "
                    f"{axis_names}) -- the plan validates against the mesh at construction")
        if self.n_micro < 1:
            raise ValueError(f"n_micro must be >= 1, got {self.n_micro}")
        if self.pp is None and self.n_micro != 1:
            raise ValueError("n_micro > 1 is the GPipe microbatch count: it needs a pp axis "
                             "(pass pp=<stage axis name>)")
        if self.prefetch_blocks < 1:
            raise ValueError(f"prefetch_blocks must be >= 1, got {self.prefetch_blocks}")

    # -- axis sizes ----------------------------------------------------------------------
    @property
    def ep_axis(self) -> str:
        """The mesh axis carrying experts (the dp axis unless another was named)."""
        return self.ep if self.ep is not None else self.dp

    def axis_size(self, logical: str) -> int:
        """|axis| of a logical role ('dp'|'sp'|'pp'|'ep'); 1 for an absent pp axis."""
        name = {"dp": self.dp, "sp": self.sp, "pp": self.pp, "ep": self.ep_axis}[logical]
        return 1 if name is None else self.mesh.shape[self.mesh.axis_names.index(name)]

    @property
    def dp_size(self) -> int:
        return self.axis_size("dp")

    @property
    def sp_size(self) -> int:
        return self.axis_size("sp")

    @property
    def pp_size(self) -> int:
        return self.axis_size("pp")

    @property
    def pipelined(self) -> bool:
        """True when the plan selects the pipelined (stacked-stage) step: a
        pp axis with more than one stage or more than one microbatch."""
        return self.pp is not None and (self.pp_size > 1 or self.n_micro > 1)

    @property
    def overlap_blocks(self) -> int:
        """Block count of the decomposed sync legs; 0 = serial."""
        return self.prefetch_blocks if self.overlap else 0

    # -- tree-path -> mesh-axes ----------------------------------------------------------
    def spec(self, *logical) -> P:
        """PartitionSpec from logical roles: each entry None, one of
        'dp'/'sp'/'pp'/'ep', or a tuple of them (one array dim over several
        mesh axes), resolved onto this plan's mesh axis names."""
        table = {"dp": self.dp, "sp": self.sp, "pp": self.pp, "ep": self.ep_axis, None: None}

        def resolve(entry):
            if isinstance(entry, tuple):
                return tuple(resolve(e) for e in entry)
            if entry not in table:
                raise ValueError(f"unknown logical axis {entry!r}: one of {_LOGICAL}")
            name = table[entry]
            if name is None and entry is not None:
                raise ValueError(f"logical axis {entry!r} is not mapped by this plan")
            return name

        return P(*(resolve(e) for e in logical))

    def tree_spec(self, tree, rule: Callable):
        """A PartitionSpec tree for ``tree``: each leaf's path (the tuple of
        dict keys and list indices) goes through ``rule(path, leaf) ->
        (logical axes...)``, resolved by :meth:`spec`."""
        return _map_with_path(lambda path, leaf: self.spec(*rule(path, leaf)), tree)

    def data_spec(self, accum_steps: int = 1) -> P:
        """Spec of a (batch, seq, d) batch: batch over dp, sequence over sp
        (a leading whole microbatch dim under accumulation)."""
        return P(self.dp, self.sp) if accum_steps == 1 else P(None, self.dp, self.sp)

    # -- identity ------------------------------------------------------------------------
    def describe(self) -> dict:
        """Normalized plan identity: axis sizes and the microbatch schedule.
        A pp=1, n_micro=1 plan describes as the plan-less dp x sp run."""
        return {
            "dp": self.dp_size,
            "sp": self.sp_size,
            "pp": self.pp_size if self.pipelined else 1,
            "n_micro": self.n_micro if self.pipelined else 1,
        }

    # -- programs ------------------------------------------------------------------------
    def pipeline_program(self, stage_fn):
        """The GPipe program over this plan's pp axis: fn(stage_params,
        micro) -> (M, ...) outputs, stage parameters split over pp on their
        leading dim, ``micro`` replicated. ``stage_fn(params, x)`` sees
        stacked values (``parallel.pipeline.pipeline_apply``)."""
        if self.pp is None:
            raise ValueError("pipeline_program needs a pp axis (pass pp=<axis name>)")
        from tpuscratch_torch.parallel.pipeline import pipeline_apply

        return run_spmd(self.mesh, lambda W, m: pipeline_apply(stage_fn, W, m, self.pp),
                        (P(self.pp), P()), P())
