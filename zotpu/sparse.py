"""Succinct sorted-set membership: rank / select / access.

Reference analog: zotmer/library/sparse.py (SURVEY.md section 2a "sparse/
succinct set"): binary-search rank-select over a sorted k-mer array, used by
scan/pulldown-style commands for membership queries.

Host-side (numpy) interface mirroring the expected reference semantics. The
device-side membership surface is the gather-free sort-merge join
(kernels/join.py), which needs no device gather per bisection step.
"""

from __future__ import annotations

import numpy as np


class SparseSet:
    """A sorted u64 array viewed as a succinct set."""

    def __init__(self, keys: np.ndarray):
        self.keys = np.asarray(keys, dtype=np.uint64)
        if len(self.keys) > 1 and not np.all(self.keys[1:] > self.keys[:-1]):
            raise ValueError("keys must be strictly sorted")

    def __len__(self) -> int:
        return len(self.keys)

    def rank(self, x) -> np.ndarray:
        """Number of elements < x (vectorized)."""
        return np.searchsorted(self.keys, np.asarray(x, np.uint64), side="left")

    def select(self, i):
        """i-th smallest element (0-based)."""
        return self.keys[i]

    def access(self, x) -> np.ndarray:
        """Membership mask (vectorized)."""
        x = np.asarray(x, np.uint64)
        idx = np.minimum(self.rank(x), max(len(self.keys) - 1, 0))
        if len(self.keys) == 0:
            return np.zeros(x.shape, bool)
        return self.keys[idx] == x

    def count_range(self, lo, hi) -> int:
        """Number of elements in [lo, hi)."""
        return int(self.rank(hi) - self.rank(lo))
