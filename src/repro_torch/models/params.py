"""Parameter trees: the reference's nested parameters as one ``nn.Module``.

The reference package keeps a model's parameters as a nested tree of dicts
and lists of arrays (``{"layer0": {"w_self": ...}, "mlp": [{"w": ...},
...]}``), described by a tree of shape tuples (``param_shapes(cfg)``).
:class:`ParamTree` allocates that tree as modules and parameters under the
same names, a list's entries under their index (``mlp.0.w``), so that
``params["mlp"][0]["w"]`` reads the same in both packages and
``state_dict()`` names every leaf by its dotted path in the tree.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def flat_leaves(tree, prefix: str = "") -> dict:
    """A nested tree (dicts and lists; a tuple is a shape, so a leaf) as
    dotted path → leaf: ``"layer0.w_self"``, ``"mlp.1.b"``."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(flat_leaves(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def check_leaves(want: dict, got: dict) -> None:
    """Raise ``ValueError`` unless ``got`` (path → array) has exactly the
    paths of ``want`` (path → shape), each with its shape."""
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"parameter tree mismatch: missing {missing}, extra {extra}")
    for name, shape in want.items():
        if tuple(np.shape(got[name])) != tuple(shape):
            raise ValueError(
                f"leaf {name!r} has shape {tuple(np.shape(got[name]))}, "
                f"expected {tuple(shape)}"
            )


class ParamTree(nn.Module):
    """The tree of ``shapes`` as uninitialised, trainable parameters of
    ``dtype`` on ``device``: a dict becomes a ``ParamTree``, a list an
    ``nn.ModuleList`` of them, a shape tuple a parameter. ``tree[name]``
    is ``getattr(tree, name)``, so the forward functions index it as the
    reference indexes its dicts."""

    def __init__(self, shapes: dict, dtype: torch.dtype, device):
        super().__init__()
        for name, s in shapes.items():
            if isinstance(s, dict):
                self.add_module(name, ParamTree(s, dtype, device))
            elif isinstance(s, list):
                self.add_module(name, nn.ModuleList(ParamTree(x, dtype, device) for x in s))
            else:
                self.register_parameter(name, nn.Parameter(
                    torch.empty(s, dtype=dtype, device=device)))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def param_tree(self) -> dict:
        """Dotted leaf path → parameter: the reference's tree, flat (a
        list's entries are leaves of their own, ``mlp.0.w``). The optimizers
        take trees of this form."""
        return dict(self.named_parameters())
