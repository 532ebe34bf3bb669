"""`ParamModule`: an nn.Module over a nested parameter tree.

The ops take nested dicts of tensors in the JAX package's layouts, so each
model piece keeps its parameters as such a tree (`module.p`) and registers
every leaf as an `nn.Parameter` named by its path (`a__b__0`), so
`state_dict()`, `.to()`, device moves and optimizers see them. The Sopro
model's leaves are trainable (`train.py` updates every one of them, as the
JAX package's optimizer does); the Mimi codec is never trained and builds
its module with `trainable=False`, so its leaves carry no gradient. Serving
runs under `torch.inference_mode()`, where `requires_grad` costs nothing.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn


def tree_map(fn, tree: Any) -> Any:
    """Apply `fn` to every tensor / array leaf of a dict/list/tuple tree
    (None stays None)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


class ParamModule(nn.Module):
    def __init__(self, tree: Any, trainable: bool = True):
        super().__init__()
        names = []

        def register(path, leaf):
            name = "__".join(path)
            self.register_parameter(name, nn.Parameter(leaf, requires_grad=trainable))
            names.append(name)
            return name

        def walk(t, path):
            if isinstance(t, dict):
                return {k: walk(v, path + (str(k),)) for k, v in t.items()}
            if isinstance(t, (list, tuple)):
                return [walk(v, path + (str(i),)) for i, v in enumerate(t)]
            if t is None:
                return None
            return register(path, t)

        self._skeleton = walk(tree, ())
        self._tree = None

    @property
    def p(self) -> Any:
        """The parameter tree, with leaves bound to this module's parameters."""
        if self._tree is None:
            self._tree = tree_map(lambda name: getattr(self, name), self._skeleton)
        return self._tree

    def _apply(self, fn, *args, **kwargs):
        out = super()._apply(fn, *args, **kwargs)
        self._tree = None  # parameters may have been replaced: rebind on next access
        return out

    def param_device(self) -> torch.device:
        return next(self.parameters()).device
