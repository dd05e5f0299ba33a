"""A configuration's database, made from --seed.

The entry lengths follow the configuration's length distribution and are
the same for every seed: a grid of protein lengths at fixed quantiles,
cut into fragments where the configuration says so, then `unique`
structures at fixed quantiles of that, each held by an equal share of the
entries. The seed makes the structures (the frozen `synthesize`) and the
order of the entries, so that two seeds do the same amount of work in
another order. The structures are made in worker processes that import
only NumPy and portbench.reference.
"""
from __future__ import annotations

import math
import multiprocessing
import os
import statistics
from concurrent.futures import ProcessPoolExecutor

import numpy as np


def protein_lengths(spec: dict) -> np.ndarray:
    """`grid` protein lengths at the quantiles (i + 0.5) / grid of a
    log-normal with the given mean and median, at least `min`."""
    mu = math.log(spec["median"])
    sigma = math.sqrt(2.0 * math.log(spec["mean"] / spec["median"]))
    nd = statistics.NormalDist()
    g = int(spec["grid"])
    z = np.array([nd.inv_cdf((i + 0.5) / g) for i in range(g)])
    return np.maximum(np.rint(np.exp(mu + sigma * z)), spec["min"]) \
        .astype(np.int64)


def entry_lengths(config: dict) -> np.ndarray:
    """The database's entry lengths, sorted: proteins above the
    fragment rule's `above` become fragments of `length` residues, one
    every `step` (AlphaFold DB's cut); the others are clipped to `max`."""
    spec = config["lengths"]
    prot = protein_lengths(spec)
    frag = config.get("fragments")
    out = []
    for n in prot:
        if frag and n > frag["above"]:
            k = math.ceil((n - frag["length"]) / frag["step"]) + 1
            out.extend([frag["length"]] * k)
        else:
            out.append(min(int(n), spec["max"]))
    return np.sort(np.asarray(out, np.int64))


def pool_plan(config: dict, n_entries: int, n_unique: int):
    """(lengths [U], entries a structure [U]) of the pool: U structures at
    the quantiles (u + 0.5) / U of the entry lengths, n_entries shared as
    evenly as the count allows."""
    ent = entry_lengths(config)
    u = np.arange(n_unique)
    lengths = ent[((u + 0.5) / n_unique * len(ent)).astype(np.int64)]
    mult = np.full(n_unique, n_entries // n_unique, np.int64)
    mult[:n_entries % n_unique] += 1
    return lengths, mult


def entry_order(mult, seed: int, salt: int = 0) -> np.ndarray:
    """The structure of each entry, in a seeded order."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 7919 + salt])
    return rng.permutation(np.repeat(np.arange(len(mult)), mult))


def workers() -> int:
    return max(1, min(7, (os.cpu_count() or 2) - 1))


def process_pool(n=None) -> ProcessPoolExecutor:
    """Worker processes started by spawn: they import portbench.reference
    (NumPy only), never torch or the port."""
    return ProcessPoolExecutor(n or workers(),
                               mp_context=multiprocessing.get_context(
                                   "spawn"))


def submit_pool(ex, lengths, seed: int, kind: str):
    """Futures of the pool's structures as `kind` ("fcz" or "pdb") bytes,
    longest first so that the slowest finish early."""
    from .reference.tasks import make_input
    order = np.argsort(-np.asarray(lengths), kind="stable")
    futs = [None] * len(lengths)
    for u in order:
        futs[u] = ex.submit(make_input, int(lengths[u]), seed, int(u), kind)
    return futs
