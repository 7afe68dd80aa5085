"""Weights from the seed, made on the device in the type they are served in.

The benchmark makes the weights, not the program: the tree of shapes comes
from ``Model.abstract_params()`` (meta tensors, nothing allocated), and each
leaf is drawn from one ``torch.Generator`` on the device in one call, in
tree order: norms' scales are ones, biases zeros, every matrix and the
embedding normal with the configuration's ``init_std`` (both served models'
published configs give ``initializer_range`` 0.02).  At that scale greedy
decoding of random weights stays diverse; at ``1/sqrt(fan_in)``, the
program's own init, granite-34b's 88 layers repeat one or two tokens, and a
check of served tokens could not tell a lower precision from the program's.
The same seed gives the same tensors, on the program's side and, drawn
again after the window, on the reference's.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import torch


def leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
           ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def fill(tree: Dict[str, Any], seed: int, std: float) -> None:
    """Draw every leaf of ``tree`` in place from ``seed``."""
    first = next(leaves(tree))[1]
    gen = torch.Generator(device=first.device).manual_seed(seed)
    for path, t in leaves(tree):
        if path[-1] == "scale":
            t.fill_(1.0)
        elif path[-1] == "b":
            t.zero_()
        else:
            t.normal_(0.0, std, generator=gen)


def make(abstract: Dict[str, Any], seed: int, device,
         std: float) -> Dict[str, Any]:
    """A tree shaped like ``abstract`` (meta tensors), on ``device``,
    filled from ``seed``."""
    def alloc(tree):
        return {k: alloc(v) if isinstance(v, dict)
                else torch.empty(v.shape, dtype=v.dtype, device=device)
                for k, v in tree.items()}
    tree = alloc(abstract)
    fill(tree, seed, std)
    return tree


def nbytes(tree: Dict[str, Any]) -> int:
    return sum(t.numel() * t.element_size() for _, t in leaves(tree))
