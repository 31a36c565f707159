"""Reverb sampling distributions: Fifo, Lifo, Uniform, Prioritized.

Prioritized uses a sum-tree for O(log n) sampling with p_i^alpha weighting
(Schaul et al., 2015) — the same scheme Acme's DQN/R2D2 use.
"""
from __future__ import annotations

import random
from typing import Dict, List, Tuple

import numpy as np


class Selector:
    consumes: bool = False     # True => sampling removes the item (queues)

    def insert(self, key: int, priority: float): ...
    def remove(self, key: int): ...
    def update(self, key: int, priority: float): ...
    def size(self) -> int:
        raise NotImplementedError

    def sample(self) -> Tuple[int, float]:
        """Returns (key, probability_of_selection)."""
        raise NotImplementedError

    # -- exact-resume serialization ------------------------------------
    # Selectors that implement both hooks restart bit-exactly: the same
    # sample() draws come out after a save/load round trip.  Selectors
    # that don't are rebuilt from the table's items on restore (correct
    # distribution, fresh RNG stream — not bit-exact).
    def state_dict(self) -> dict:
        raise NotImplementedError(
            f"{type(self).__name__} does not support exact-resume "
            "serialization; the table will rebuild it from item priorities")

    def load_state_dict(self, state: dict):
        raise NotImplementedError


class Fifo(Selector):
    consumes = True

    def __init__(self):
        self._keys: List[int] = []

    def size(self):
        return len(self._keys)

    def insert(self, key, priority):
        self._keys.append(key)

    def remove(self, key):
        try:
            self._keys.remove(key)
        except ValueError:
            pass

    def update(self, key, priority):
        pass

    def sample(self):
        if not self._keys:
            raise IndexError("empty")
        return self._keys.pop(0), 1.0

    def state_dict(self):
        return {"kind": type(self).__name__, "keys": list(self._keys)}

    def load_state_dict(self, state):
        self._keys = list(state["keys"])


class Lifo(Fifo):
    def sample(self):
        if not self._keys:
            raise IndexError("empty")
        return self._keys.pop(), 1.0


class Uniform(Selector):
    def __init__(self, seed: int = 0):
        self._keys: List[int] = []
        self._pos: Dict[int, int] = {}
        self._rng = random.Random(seed)

    def insert(self, key, priority):
        self._pos[key] = len(self._keys)
        self._keys.append(key)

    def remove(self, key):
        pos = self._pos.pop(key, None)
        if pos is None:
            return
        last = self._keys.pop()
        if last != key:
            self._keys[pos] = last
            self._pos[last] = pos

    def update(self, key, priority):
        pass

    def sample(self):
        if not self._keys:
            raise IndexError("empty")
        k = self._rng.choice(self._keys)
        return k, 1.0 / len(self._keys)

    def state_dict(self):
        # _keys order matters: rng.choice indexes into it, so restoring the
        # same order + the same rng state reproduces the draw sequence.
        return {"kind": "Uniform", "keys": list(self._keys),
                "rng": self._rng.getstate()}

    def load_state_dict(self, state):
        self._keys = list(state["keys"])
        self._pos = {k: i for i, k in enumerate(self._keys)}
        self._rng.setstate(state["rng"])


class SumTree:
    """Classic array-backed sum tree over slot indices."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.tree = np.zeros(2 * capacity, np.float64)

    def set(self, idx: int, value: float):
        i = idx + self.capacity
        delta = value - self.tree[i]
        while i:
            self.tree[i] += delta
            i //= 2

    def get(self, idx: int) -> float:
        return float(self.tree[idx + self.capacity])

    def total(self) -> float:
        return float(self.tree[1])

    def find(self, mass: float) -> int:
        i = 1
        while i < self.capacity:
            left = 2 * i
            if mass <= self.tree[left] or self.tree[left + 1] <= 0:
                i = left
            else:
                mass -= self.tree[left]
                i = left + 1
        return i - self.capacity


class Prioritized(Selector):
    def __init__(self, priority_exponent: float = 0.6, capacity: int = 1 << 20,
                 seed: int = 0):
        self.alpha = priority_exponent
        self._tree = SumTree(capacity)
        self._slot: Dict[int, int] = {}
        self._key_of: Dict[int, int] = {}
        self._free: List[int] = list(range(capacity - 1, -1, -1))
        self._rng = random.Random(seed)

    def _p(self, priority: float) -> float:
        return float(max(priority, 1e-12) ** self.alpha)

    def insert(self, key, priority):
        slot = self._free.pop()
        self._slot[key] = slot
        self._key_of[slot] = key
        self._tree.set(slot, self._p(priority))

    def remove(self, key):
        slot = self._slot.pop(key, None)
        if slot is None:
            return
        self._tree.set(slot, 0.0)
        self._key_of.pop(slot, None)
        self._free.append(slot)

    def update(self, key, priority):
        slot = self._slot.get(key)
        if slot is not None:
            self._tree.set(slot, self._p(priority))

    def sample(self):
        total = self._tree.total()
        if total <= 0:
            raise IndexError("empty")
        slot = self._tree.find(self._rng.random() * total)
        key = self._key_of.get(slot)
        if key is None:  # numerical edge: fall back to any live key
            key = next(iter(self._slot))
            slot = self._slot[key]
        return key, self._tree.get(slot) / total

    def state_dict(self):
        # The tree array is serialized VERBATIM: set() accumulates
        # incremental float deltas, so rebuilding from priorities would
        # round internal sums differently and shift find() boundaries —
        # breaking bit-exact resume.
        return {"kind": "Prioritized", "alpha": self.alpha,
                "capacity": self._tree.capacity,
                "tree": self._tree.tree.copy(),
                "slot": dict(self._slot),
                "free": list(self._free),
                "rng": self._rng.getstate()}

    def load_state_dict(self, state):
        if int(state["capacity"]) != self._tree.capacity:
            raise ValueError(
                f"Prioritized capacity mismatch: checkpoint has "
                f"{state['capacity']}, selector has {self._tree.capacity}")
        self.alpha = float(state["alpha"])
        self._tree.tree = np.asarray(state["tree"], np.float64).copy()
        self._slot = {int(k): int(s) for k, s in state["slot"].items()}
        self._key_of = {s: k for k, s in self._slot.items()}
        self._free = [int(s) for s in state["free"]]
        self._rng.setstate(state["rng"])
