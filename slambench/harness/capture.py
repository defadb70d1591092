"""What the timed path produced, kept for the comparison after the window.

Calls into the port are sampled by reservoir sampling from a generator
seeded from the run's seed: every call of a kind in the window has the same
chance to be kept, and at most `k` of each kind are held. A kept call holds
references to its inputs and outputs. The port's map updates are
functional (a new map per update, the old one untouched), so a reference
to the map a step ran on is that step's state, with no copy."""

from __future__ import annotations

import random


class Reservoir:
    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, make_item) -> None:
        """make_item() builds the item only when it is kept."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make_item())
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = make_item()


class Capture:
    def __init__(self, seed: int, sizes: dict):
        self.rng = random.Random(int(seed) * 7919 + 17)
        self.sizes = sizes
        self.kinds = {}
        self.on = False

    def offer(self, kind: str, make_item) -> None:
        if not self.on:
            return
        if kind not in self.kinds:
            self.kinds[kind] = Reservoir(int(self.sizes.get(kind.split(".")[0], 4)), self.rng)
        self.kinds[kind].offer(make_item)

    def items(self, prefix: str):
        return [it for kind, r in sorted(self.kinds.items())
                if kind == prefix or kind.startswith(prefix + ".") for it in r.items]

    def seen(self, prefix: str) -> int:
        return sum(r.seen for kind, r in self.kinds.items()
                   if kind == prefix or kind.startswith(prefix + "."))
