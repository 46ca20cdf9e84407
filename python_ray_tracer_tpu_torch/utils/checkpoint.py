"""Path-keyed checkpoints of tensor trees, and Adam's state in optax's layout.

PyTorch counterpart of ``python_ray_tracer_tpu/utils/checkpoint.py``: a tree
of tensors (dataclasses such as ``Scene``, dicts, lists, tuples and named
tuples) round-trips through a flat ``.npz`` keyed by each leaf's path, written
exactly as ``jax.tree_util.keystr`` writes it (``.spheres.center``,
``['scene']``, ``[0]``, ``<root>`` for a lone leaf; dict keys sorted, as JAX
flattens them). A checkpoint therefore crosses between the two packages in
both directions, and a tree whose paths differ from the file's fails loudly
instead of loading leaves by position.

The optimizer state crosses too. The JAX package's fits keep ``optax.adam``'s
state, ``(ScaleByAdamState(count, mu, nu), EmptyState())`` with ``mu`` and
``nu`` shaped like the scene; the port's keep a ``torch.optim.Adam`` over the
trainable leaves (``train.make_train_step``). :func:`adam_state` writes the
torch optimizer's state in optax's layout (``count`` from ``step``, ``mu``
from ``exp_avg``, ``nu`` from ``exp_avg_sq``, zeros for the frozen leaves,
which is optax's state under ``train._mask_grads``), and
:func:`load_adam_state` puts such a state back into the optimizer. Both
follow the same update rule, so a fit resumes from either package's file.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..models.scene import LEAF_PATHS, Scene


class ScaleByAdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the step count and both moments."""
    count: Any
    mu: Any
    nu: Any


class EmptyState(NamedTuple):
    """optax's ``EmptyState``: the state of ``scale_by_learning_rate``."""


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, int, float, bool))


def _children(tree) -> List[Tuple[str, Any]]:
    """``(key, child)`` pairs of one tree node, as ``jax.tree_util.keystr``
    writes each step of a path."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", x) for i, x in enumerate(tree)]
    if dataclasses.is_dataclass(tree):
        return [(f".{f.name}", getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    raise TypeError(f"not a tree node or leaf: {type(tree).__name__}")


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if tree is None:
        return []
    if _is_leaf(tree):
        return [(prefix or "<root>", tree)]
    return [kv for key, child in _children(tree) for kv in _flatten(child, prefix + key)]


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in order from ``leaves``."""
    if tree is None:
        return None
    if _is_leaf(tree):
        return next(leaves)
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), leaves) for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, leaves) for x in tree)
    return dataclasses.replace(tree, **{f.name: _rebuild(getattr(tree, f.name), leaves)
                                        for f in dataclasses.fields(tree)})


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_pytree(path: str, tree) -> None:
    """Write ``tree``'s leaves to ``path`` (``np.savez``), keyed by path."""
    items = _flatten(tree)
    keys = [k for k, _ in items]
    if len(set(keys)) != len(keys):
        raise ValueError("duplicate leaf paths in the tree")
    np.savez(path, **{k: _numpy(x) for k, x in items})


def load_pytree(path: str, like):
    """Load leaves saved by :func:`save_pytree` (or by the JAX package's) into
    the structure of ``like``: tensors of the saved dtypes, each on the
    device of ``like``'s leaf where that is a tensor (else the CPU). Every
    leaf path of ``like`` must be in the file and the reverse; a mismatch
    raises ``ValueError`` with the missing and extra paths."""
    items = _flatten(like)
    with np.load(path) as data:
        saved, want = set(data.files), {k for k, _ in items}
        if saved != want:
            missing, extra = sorted(want - saved), sorted(saved - want)
            # a set, not a sorted list: lexicographic order puts leaf_10
            # before leaf_2
            if not (want & saved) and extra and \
                    set(extra) == {f"leaf_{i}" for i in range(len(extra))}:
                raise ValueError("checkpoint uses the legacy positional leaf_<i> format; "
                                 "re-save it with the current save_pytree (path-keyed) to "
                                 "load it")
            raise ValueError(f"checkpoint/template leaf-path mismatch: missing={missing} "
                             f"extra={extra}")
        leaves = [torch.from_numpy(np.array(data[k])).to(
            x.device if isinstance(x, torch.Tensor) else "cpu") for k, x in items]
    return _rebuild(like, iter(leaves))


def _adam_param_state(optimizer: torch.optim.Adam) -> Tuple[list, List[dict]]:
    params = [p for g in optimizer.param_groups for p in g["params"]]
    return params, [optimizer.state.get(p, {}) for p in params]


def adam_state(optimizer: torch.optim.Adam, scene: Scene,
               trainable: Sequence[str]) -> tuple:
    """``optimizer`` (a ``torch.optim.Adam`` over ``scene``'s leaves at the
    paths ``trainable``, in its parameter order, as ``train.make_train_step``
    builds it) in ``optax.adam``'s state layout: ``(ScaleByAdamState(count,
    mu, nu), EmptyState())``, ``count`` an int32 tensor, ``mu`` and ``nu``
    scenes whose frozen leaves are zeros."""
    params, states = _adam_param_state(optimizer)
    if len(params) != len(trainable):
        raise ValueError(f"{len(params)} parameters, {len(trainable)} trainable paths")
    steps = {int(st["step"]) for st in states if "step" in st}
    if len(steps) > 1:
        raise ValueError(f"the parameters took different numbers of steps: {sorted(steps)}")
    moments = {}
    for path, st in zip(trainable, states):
        moments[path] = (st.get("exp_avg"), st.get("exp_avg_sq"))
    mu, nu = [], []
    for path, leaf in zip(LEAF_PATHS, scene.leaves()):
        m, v = moments.get(path, (None, None))
        mu.append(torch.zeros_like(leaf) if m is None else m.detach().clone().reshape(leaf.shape))
        nu.append(torch.zeros_like(leaf) if v is None else v.detach().clone().reshape(leaf.shape))
    count = torch.tensor(steps.pop() if steps else 0, dtype=torch.int32)
    return (ScaleByAdamState(count, Scene.from_leaves(mu), Scene.from_leaves(nu)), EmptyState())


def load_adam_state(optimizer: torch.optim.Adam, state, trainable: Sequence[str]) -> None:
    """Put an ``optax.adam`` state (:func:`adam_state`'s layout, from either
    package's checkpoint) into ``optimizer``, in place: ``step`` from
    ``count``, ``exp_avg`` / ``exp_avg_sq`` from the trainable leaves of
    ``mu`` / ``nu``."""
    adam = state[0]
    params, _ = _adam_param_state(optimizer)
    if len(params) != len(trainable):
        raise ValueError(f"{len(params)} parameters, {len(trainable)} trainable paths")
    mu = dict(zip(LEAF_PATHS, adam.mu.leaves()))
    nu = dict(zip(LEAF_PATHS, adam.nu.leaves()))
    count = float(adam.count)
    for p, path in zip(params, trainable):
        optimizer.state[p] = {
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": mu[path].to(p.device, p.dtype).reshape(p.shape).clone(),
            "exp_avg_sq": nu[path].to(p.device, p.dtype).reshape(p.shape).clone()}
