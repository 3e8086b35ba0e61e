"""The one traffic generator: reads a mix's parameters (``traffic/<mix>
.json``) and draws requests from the seed.

Sizes are the distribution's quantiles at (i + 0.5) / n, put in an
order drawn from the mix's own ``schedule_seed``: every run of a mix gets
the same schedule of sizes, and ``--seed`` draws the token ids (uniform
over the vocabulary) and the weights. Which prompts are admitted together
decides the tails, so the order is not the seed's to change.

Length distributions (``{"dist": ...}``): ``lognormal`` (median, sigma,
min, max), ``uniform`` (min, max, both included), ``const`` (value).
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist

import numpy as np


def quantiles(spec: dict, n: int) -> np.ndarray:
    """n integer lengths at the quantiles (i + 0.5) / n of ``spec``."""
    u = (np.arange(n) + 0.5) / n
    kind = spec["dist"]
    if kind == "lognormal":
        z = np.array([NormalDist().inv_cdf(x) for x in u])
        x = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
        x = np.clip(np.rint(x), spec["min"], spec["max"])
    elif kind == "uniform":
        x = spec["min"] + np.floor(u * (spec["max"] - spec["min"] + 1))
    elif kind == "const":
        x = np.full(n, spec["value"])
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return x.astype(np.int64)


@dataclasses.dataclass
class Draw:
    prompt_len: int
    output_len: int


class Mix:
    """Requests of one closed-loop mix; token ids from the seed. Each of
    ``clients`` clients sends its next request once its last one has
    finished; request k takes entry k mod ``pool`` of a pool of sizes."""

    def __init__(self, t: dict, seed: int, vocab: int):
        self.t, self.vocab = t, vocab
        self.rng = np.random.default_rng([seed, 1])
        order = np.random.default_rng(t["schedule_seed"])
        n = t["pool"]
        self.prompts = order.permutation(quantiles(t["prompt"], n))
        self.outputs = order.permutation(quantiles(t["output"], n))
        self.n = n

    def draw(self, k: int) -> Draw:
        i = k % self.n
        return Draw(int(self.prompts[i]), int(self.outputs[i]))

    def ids(self, length: int) -> list[int]:
        """The next prompt's token ids (drawn in request order)."""
        return self.rng.integers(0, self.vocab, length).tolist()
