"""What the drivers share: the seeded endless order of entries, the link
probe in set-up, and the product's batch size."""
from __future__ import annotations

import threading

import numpy as np

from .. import data


class EntryStream:
    """Structure ids of an endless database sweep: pass k is a fresh
    seeded permutation of every entry. `units` keeps each yielded entry's
    structure, by index."""

    def __init__(self, mult, seed: int):
        self.mult = mult
        self.seed = seed
        self.units = []

    def __iter__(self):
        k = 0
        while True:
            for u in data.entry_order(self.mult, self.seed, salt=k):
                self.units.append(int(u))
                yield len(self.units) - 1, int(u)
            k += 1


def probe_in_background(ctx):
    """The product's link probe (cli._probe_info), run in set-up beside
    the inputs, so that none pays it inside the window. No run finds it
    cached by an earlier one: the run's temporary directory, where the
    product caches its answer, is new (run.py). Returns the thread."""
    from foldcomp_tpu_torch import cli
    out = {}

    def go():
        out["probe"] = cli._probe_info()

    th = threading.Thread(target=go, daemon=True)
    th.start()
    ctx.probe_result = out
    return th


def product_batch(ctx) -> int:
    from foldcomp_tpu_torch import cli
    bsz = cli.fast_batch_size()
    ctx.log("probe", ctx.probe_result.get("probe"), "batch", bsz)
    return bsz


def sample_filter(seed: int, every: int):
    """A seeded 1-in-`every` choice of entry indices."""
    off = int(np.random.default_rng([int(seed) % (1 << 63), 104729])
              .integers(every))
    return lambda i: (i + off) % every == 0
