"""Lazy batch sequences (loaders/batches/_sequences.py equivalents:
Map, Local, shuffle, to_local; a copy of the JAX package's
``data/sequences.py``)."""

from __future__ import annotations

import os
import pickle
from typing import Callable, Sequence

import numpy as np


class Map(Sequence):
    """Lazily apply a function over a sequence."""

    def __init__(self, fn: Callable, seq: Sequence):
        self.fn = fn
        self.seq = seq

    def __getitem__(self, i):
        return self.fn(self.seq[i])

    def __len__(self):
        return len(self.seq)


class Local(Sequence):
    """A sequence backed by pickled files in a directory."""

    def __init__(self, path: str):
        self.path = path
        self.files = sorted(
            f for f in os.listdir(path) if f.endswith(".pkl")
        )

    def __getitem__(self, i):
        with open(os.path.join(self.path, self.files[i]), "rb") as f:
            return pickle.load(f)

    def __len__(self):
        return len(self.files)


def to_local(seq: Sequence, path: str) -> Local:
    os.makedirs(path, exist_ok=True)
    for i, item in enumerate(seq):
        with open(os.path.join(path, f"{i:06d}.pkl"), "wb") as f:
            pickle.dump(item, f)
    return Local(path)


def shuffle(seq: Sequence, seed: int = 0) -> Map:
    rng = np.random.RandomState(seed)
    order = rng.permutation(len(seq))
    return Map(lambda i: i, [seq[int(j)] for j in order])
