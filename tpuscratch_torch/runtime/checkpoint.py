"""Checkpoint / resume for iterative distributed computations.

The twin of ``tpuscratch.runtime.checkpoint``, in the same on-disk
format: one directory a step holding the tree's leaves as ``.npy`` plus a
JSON manifest (treedef, step, per-leaf shape/dtype/file-size, user
metadata). The leaves are flattened as ``jax.tree.flatten`` orders them
(dict keys sorted, lists and tuples in order, ``None`` holds no leaf), so
either package restores the other's checkpoints bit for bit. Atomic via
write-to-temp + rename; ``latest_step`` + ``restore`` give
resume-after-preemption.

Crash safety: a same-step overwrite renames the published dir ASIDE
(call-unique name), publishes the new one, then deletes the aside — so
no kill point loses an already-published step.  The read path
(``steps``/``restore``) RECOGNIZES a stranded aside as that step and
never renames or deletes anything, so concurrent readers cannot race an
in-flight save; the writer's next ``save`` runs :func:`_gc`, which
renames an unreplaced aside back and deletes orphaned ``.tmp_step_*``
write temps. ``save`` takes a ``hook`` called at each internal stage —
the chaos harness's injection point.

Leaves may be torch tensors (on any device: each is copied to host
memory before ``np.save``), numpy arrays or Python numbers. A dtype that
numpy cannot hold natively (bfloat16) is refused, never cast. Restored
leaves take their example leaf's kind: a tensor comes back as a tensor
on the example's device, anything else as a numpy array. The aside/GC
scheme assumes one writer per directory.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import tempfile
import uuid
from typing import Any, Callable, Optional

import numpy as np
import torch

from tpuscratch_torch.runtime.errors import CommError

_MANIFEST = "manifest.json"
_TMP_PREFIX = ".tmp_step_"
_OLD_PREFIX = ".old_step_"


# ---- the tree, flattened as jax.tree.flatten does ------------------------


def tree_flatten(tree: Any) -> tuple[list, str]:
    """(leaves, treedef string) in ``jax.tree.flatten``'s order: dict
    keys sorted, lists and tuples in order, ``None`` an empty node. The
    string reads as a ``PyTreeDef``'s does."""
    if tree is None:
        return [], "None"
    if isinstance(tree, dict):
        leaves, parts = [], []
        for k in sorted(tree):
            sub, d = tree_flatten(tree[k])
            leaves += sub
            parts.append(f"{k!r}: {d}")
        return leaves, "{" + ", ".join(parts) + "}"
    if isinstance(tree, (list, tuple)):
        leaves, parts = [], []
        for v in tree:
            sub, d = tree_flatten(v)
            leaves += sub
            parts.append(d)
        if isinstance(tree, list):
            return leaves, "[" + ", ".join(parts) + "]"
        return leaves, "(" + ", ".join(parts) + ("," if len(parts) == 1 else "") + ")"
    return [tree], "*"


def tree_unflatten(example: Any, leaves) -> Any:
    """``example``'s structure with its leaves taken in order from
    ``leaves`` (an iterable): the inverse of :func:`tree_flatten`."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}  # the example's key order
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(example)


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over every leaf, structure kept."""
    leaves, _ = tree_flatten(tree)
    return tree_unflatten(tree, [fn(x) for x in leaves])


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    try:
        return torch.empty((), dtype=dtype).numpy().dtype
    except TypeError:
        raise ValueError(
            f"a {dtype} leaf has no native numpy dtype: the checkpoint format "
            "stores .npy files, so it is refused rather than cast") from None


def to_numpy(leaf) -> np.ndarray:
    """One leaf as a host numpy array: a tensor is copied off its device
    (a blocking copy), a numpy array or number taken as it is."""
    if isinstance(leaf, torch.Tensor):
        _np_dtype(leaf.dtype)
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def to_host(tree: Any) -> Any:
    """The tree with every leaf a host numpy array (:func:`to_numpy`)."""
    return tree_map(to_numpy, tree)


def _leaf_dtype(example) -> np.dtype:
    if isinstance(example, torch.Tensor):
        return _np_dtype(example.dtype)
    return np.dtype(getattr(example, "dtype", None) or np.asarray(example).dtype)


# ---- the directory ----------------------------------------------------


def _aside_step(name: str) -> int:
    return int(name[len(_OLD_PREFIX):].split("_")[0])


def _gc(root: pathlib.Path) -> None:
    """Collect debris from crashed saves — called by the single WRITER
    (``save``) only; the read path never mutates (it *recognizes*
    stranded asides instead, :func:`_step_dir`).  Orphaned write temps
    are deleted; an aside whose replacement never published is renamed
    BACK, otherwise deleted."""
    if not root.exists():
        return
    for p in root.iterdir():
        if not p.is_dir():
            continue
        if p.name.startswith(_TMP_PREFIX):
            shutil.rmtree(p, ignore_errors=True)
        elif p.name.startswith(_OLD_PREFIX):
            final = root / f"step_{_aside_step(p.name):09d}"
            if final.exists():
                shutil.rmtree(p, ignore_errors=True)
            else:
                p.rename(final)


def _step_dir(root: pathlib.Path, step: int) -> pathlib.Path:
    """Directory holding checkpoint ``step`` — normally
    ``step_<step>``, falling back to a stranded ``.old_step_<step>_*``
    aside (a crash between the aside-rename and the publish).  Pure
    lookup: readers never rename, so they can never race the writer's
    swap window."""
    final = root / f"step_{step:09d}"
    if final.exists():
        return final
    for p in root.iterdir():
        if (p.is_dir() and p.name.startswith(_OLD_PREFIX)
                and _aside_step(p.name) == step
                and (p / _MANIFEST).exists()):
            return p
    return final


def save(ckpt_dir: str | os.PathLike, step: int, tree: Any,
         metadata: Optional[dict] = None, tag: str = "state",
         hook: Optional[Callable[[str], None]] = None) -> pathlib.Path:
    """Atomically write ``tree`` as checkpoint ``step``. Returns the path.

    ``hook`` (chaos/testing only) is called with a stage name at each
    internal boundary: ``"begin"``, ``"leaf_<i>"`` after each leaf
    write, ``"manifest"``, ``"swap"`` after an existing same-step dir is
    renamed aside, ``"publish"`` after the temp dir is renamed into
    place, ``"end"`` after the aside dir is removed.  A hook that raises
    (or kills the process) at ANY stage leaves the directory with every
    previously-published step intact — either directly or via the next
    call's :func:`_gc`."""
    root = pathlib.Path(ckpt_dir)
    root.mkdir(parents=True, exist_ok=True)
    _gc(root)
    fire = hook if hook is not None else (lambda stage: None)
    leaves, treedef = tree_flatten(tree)
    tmp = pathlib.Path(
        tempfile.mkdtemp(prefix=f"{_TMP_PREFIX}{step}_", dir=root)
    )
    final = root / f"step_{step:09d}"
    old: Optional[pathlib.Path] = None
    try:
        fire("begin")
        leaf_meta = []
        for i, leaf in enumerate(leaves):
            arr = to_numpy(leaf)
            path_i = tmp / f"leaf_{i}.npy"
            np.save(path_i, arr)
            # per-leaf identity + on-disk byte size: restore's cheap
            # torn-write check (a truncated .npy fails BEFORE np.load)
            leaf_meta.append({
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "size": path_i.stat().st_size,
            })
            fire(f"leaf_{i}")
        (tmp / _MANIFEST).write_text(
            json.dumps(
                {
                    "step": step,
                    "tag": tag,
                    "n_leaves": len(leaves),
                    "treedef": f"PyTreeDef({treedef})",
                    "leaves": leaf_meta,
                    "metadata": metadata or {},
                }
            )
        )
        fire("manifest")
        if final.exists():
            # overwrite: aside-publish-delete, never delete-then-publish
            # (a crash between rmtree and rename would lose the step).
            # The aside name is unique PER CALL, not per process: a
            # watchdog-abandoned save's zombie thread must never collide
            # with its retry on the same aside path
            old = root / (
                f"{_OLD_PREFIX}{step}_{os.getpid()}_{uuid.uuid4().hex[:8]}"
            )
            final.rename(old)
            fire("swap")
        tmp.rename(final)  # atomic publish
        fire("publish")
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
            old = None
        fire("end")
        return final
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        if old is not None:
            if final.exists():
                shutil.rmtree(old, ignore_errors=True)
            else:
                old.rename(final)  # put the published step back
        raise


def steps(ckpt_dir: str | os.PathLike) -> list[int]:
    """Published step numbers, NEWEST state of the directory — including
    steps stranded under ``.old_step_*`` asides by a crash between the
    aside-rename and the publish.  Pure read: nothing is renamed or
    deleted here (the writer's next ``save`` does that), so concurrent
    readers can never break an in-flight save."""
    root = pathlib.Path(ckpt_dir)
    if not root.exists():
        return []
    published = set()
    stranded = set()
    for p in root.iterdir():
        if not p.is_dir() or not (p / _MANIFEST).exists():
            continue
        if p.name.startswith("step_"):
            published.add(int(p.name.split("_")[1]))
        elif p.name.startswith(_OLD_PREFIX):
            stranded.add(_aside_step(p.name))
    return sorted(published | stranded)


def latest_step(ckpt_dir: str | os.PathLike) -> Optional[int]:
    found = steps(ckpt_dir)
    return found[-1] if found else None


def restore(ckpt_dir: str | os.PathLike, example_tree: Any,
            step: Optional[int] = None,
            mesh_shape: Optional[dict] = None,
            reshard: bool = False) -> tuple[Any, int, dict]:
    """Load (tree, step, metadata); ``example_tree`` supplies the
    structure, and each restored leaf the kind and device of its example
    leaf (a tensor on the example's device, else a numpy array).

    Defaults to the latest step. Validation is per-leaf, not just a
    count: each leaf's on-disk file size is checked against the manifest
    (torn/truncated writes fail before the load) and its shape and dtype
    against the example tree (a corrupted or drifted leaf fails loudly
    instead of mis-loading silently).

    ``mesh_shape`` (e.g. ``{"dp": 2, "sp": 2}``): callers restoring
    MESH-SHARDED leaves — the ZeRO trainer's dp-sharded flat optimizer
    moments — pass the mesh they will lay the state out on; if the
    manifest metadata recorded a different ``mesh_shape`` at save time,
    restore raises a :class:`runtime.errors.CommError` BEFORE any leaf
    load (the sharded layout is part of the data's meaning, and a
    shape-coincidence mis-load would silently scramble shards).

    ``reshard=True`` is the elastic escape hatch: the mesh-shape gate is
    waived and each leaf is loaded in its SAVED layout — validated
    against the manifest's recorded shape/dtype instead of the example
    tree where the two disagree — so the caller can regroup it onto the
    live mesh explicitly (``models.zero.reshard_state`` for ZeRO
    moments; the chunk drivers re-decompose their tiles).  The structure
    and leaf count must still match: resharding re-lays-out data, it
    does not migrate structures.
    """
    step, manifest = _read_manifest(ckpt_dir, step)
    if mesh_shape is not None and not reshard:
        saved = manifest.get("metadata", {}).get("mesh_shape")
        if saved is not None and saved != mesh_shape:
            saved_plan = manifest.get("metadata", {}).get("plan")
            raise CommError(
                "ckpt/restore",
                f"checkpoint step {step} in {ckpt_dir} holds leaves "
                f"sharded for mesh {saved}"
                + (f" (plan {saved_plan})" if saved_plan else "")
                + f", caller's mesh is {mesh_shape} — mesh-sharded "
                f"state cannot be re-laid-out implicitly; pass "
                f"reshard=True to load the saved layout and regroup it "
                f"onto the live mesh (models.zero.reshard_state for "
                f"ZeRO optimizer moments)",
            )
    path = _step_dir(pathlib.Path(ckpt_dir), step)
    leaves, _ = tree_flatten(example_tree)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, example tree "
            f"has {len(leaves)} — structure changed since save"
        )
    leaf_meta = manifest.get("leaves")  # absent in legacy checkpoints
    loaded = []
    for i, example in enumerate(leaves):
        f = path / f"leaf_{i}.npy"
        if leaf_meta is not None:
            size = f.stat().st_size
            if size != leaf_meta[i]["size"]:
                raise ValueError(
                    f"checkpoint leaf {i} is {size} B on disk, manifest "
                    f"recorded {leaf_meta[i]['size']} B — torn or "
                    f"corrupted write"
                )
        arr = np.load(f)
        ex_shape = tuple(example.shape) if isinstance(example, torch.Tensor) \
            else tuple(np.shape(example))
        ex_dtype = _leaf_dtype(example)
        if arr.shape != ex_shape or arr.dtype != ex_dtype:
            if not (reshard and leaf_meta is not None
                    and list(arr.shape) == leaf_meta[i]["shape"]
                    and str(arr.dtype) == leaf_meta[i]["dtype"]):
                raise ValueError(
                    f"checkpoint leaf {i} has shape {arr.shape} dtype "
                    f"{arr.dtype}; example tree expects {ex_shape} "
                    f"{ex_dtype} — structure drifted since save"
                )
            # else: the saved layout, intact per the manifest, for the
            # caller's explicit regroup
        if isinstance(example, torch.Tensor):
            arr = torch.from_numpy(arr).to(example.device)
        loaded.append(arr)
    return tree_unflatten(example_tree, loaded), step, manifest["metadata"]


def _read_manifest(ckpt_dir: str | os.PathLike, step: Optional[int]) -> tuple[int, dict]:
    """Resolve ``step`` (default: latest) and load its manifest."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = _step_dir(pathlib.Path(ckpt_dir), step)
    return step, json.loads((path / _MANIFEST).read_text())


def peek_metadata(ckpt_dir: str | os.PathLike, step: Optional[int] = None) -> tuple[int, dict]:
    """(step, metadata) without loading any leaf arrays — the cheap
    pre-restore compatibility check (manifest.json only)."""
    step, manifest = _read_manifest(ckpt_dir, step)
    return step, manifest["metadata"]


def prune(ckpt_dir: str | os.PathLike, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` checkpoints."""
    for s in steps(ckpt_dir)[:-keep] if keep > 0 else steps(ckpt_dir):
        shutil.rmtree(pathlib.Path(ckpt_dir) / f"step_{s:09d}", ignore_errors=True)
