"""Neighbours on the grid, as GCM-Filters defines them: x periodic, y
periodic, or with the tripolar fold at the top (the north neighbour of the
top row is the top row reversed in x)."""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch


def north(f: torch.Tensor, fold: bool = False) -> torch.Tensor:
    if fold:
        return torch.cat([f[..., 1:, :], f[..., -1:, :].flip(-1)], dim=-2)
    return torch.roll(f, -1, dims=-2)


def south(f: torch.Tensor) -> torch.Tensor:
    return torch.roll(f, 1, dims=-2)


def east(f: torch.Tensor) -> torch.Tensor:
    return torch.roll(f, -1, dims=-1)


def west(f: torch.Tensor) -> torch.Tensor:
    return torch.roll(f, 1, dims=-1)


@dataclasses.dataclass
class Operator:
    """A grid Laplacian in the reference: ``laplacian`` maps a tuple of
    fields to theirs; ``prepare`` and ``finalize`` wrap the whole filter
    (the fixed-factor area weighting); ``dimensional`` says whether the
    Laplacian carries the metrics' units."""

    laplacian: Callable[..., Tuple[torch.Tensor, ...]]
    dimensional: bool
    prepare: Callable[..., Tuple[torch.Tensor, ...]] = lambda *f: f
    finalize: Callable[..., Tuple[torch.Tensor, ...]] = lambda *f: f
