"""`ParamModule`: an nn.Module over a nested parameter tree.

The ops take nested dicts of tensors in the JAX package's layouts, so each
model piece keeps its parameters as such a tree (`module.p`) and registers
every leaf as a buffer, so `state_dict()`, `.to()` and device moves see them.
This slice serves only, so leaves are buffers, not trainable Parameters.
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
    def __init__(self, tree: Any):
        super().__init__()
        names = []

        def register(path, leaf):
            name = "__".join(path)
            self.register_buffer(name, leaf)
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
        """The parameter tree, with leaves bound to this module's buffers."""
        if self._tree is None:
            self._tree = tree_map(lambda name: getattr(self, name), self._skeleton)
        return self._tree

    def _apply(self, fn, *args, **kwargs):
        out = super()._apply(fn, *args, **kwargs)
        self._tree = None  # buffers were replaced: rebind on next access
        return out

    def param_device(self) -> torch.device:
        return next(self.buffers()).device
