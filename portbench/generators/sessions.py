"""The general traffic generator: greedy requests from a traffic file.

A traffic file (``traffic/<mix>.json``) gives:

- ``loop``: ``"closed"`` (``clients`` callers, each sending its next request
  when the last one finished) or ``"open"`` (Poisson arrivals at
  ``rate_per_s``: independent exponential gaps, sent on schedule whatever
  is in flight);
- ``prompt`` and ``output``: length distributions in tokens,
  ``{"dist": "lognormal", "median", "sigma", "min", "max"}``,
  ``{"dist": "exponential", "mean" or "median", "min", "max"}`` or
  ``{"dist": "uniform", "min", "max"}``, both ends included; with
  ``documents`` the prompt length is that of the question after the
  document;
- ``documents`` (optional): ``{"count", "tokens"}``: every request starts
  with one of ``count`` documents of ``tokens`` tokens, chosen evenly; the
  set-up prefills each document once;
- ``block``: the stratum size of the lengths (below);
- ``order`` (optional): ``"fixed"`` gives every seed the same order of
  sizes and the same arrival gaps (one replayed schedule); the seed then
  draws only the token ids. By default the seed orders the sizes and draws
  the gaps;
- ``source`` (optional, not read): where the lengths and arrivals come from.

Every seed gets the same lengths in another order. Lengths and document
choices come in blocks of ``block`` requests: a block holds each
distribution's quantiles at (i + 0.5) / block, paired across prompt,
output and document by one fixed shuffle, so each block of every seed
holds the same requests' sizes; the seed orders them. An open loop's gaps
are not stratified: each is an independent exponential draw, so the
arrivals keep a Poisson process's bursts. Token ids, the documents' among
them, are uniform over the vocabulary, drawn from the seed. A closed loop's
first round is a block of ``clients`` requests of its own, their outputs
scaled by evenly spaced factors in (0, 1] (paired by the same fixed
shuffle), so that the first finishes are spread out and the warm-up is the
same work for every seed.
"""

from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist
from typing import List, Optional

import numpy as np

SEED_MASK = (1 << 64) - 1
FIXED_PAIRING = 20231
FIXED_ORDER = 20232
FIXED_ARRIVALS = 20233


@dataclass
class Spec:
    """One request as the generator makes it: ``prompt`` token ids,
    ``max_new`` output tokens, ``shared`` leading tokens that are a
    document's (0 without documents)."""
    prompt: List[int]
    max_new: int
    shared: int = 0


def quantiles(dist: dict, n: int) -> np.ndarray:
    """The integer lengths of ``dist`` at the quantiles (i + 0.5) / n."""
    u = (np.arange(n) + 0.5) / n
    lo, hi = int(dist["min"]), int(dist["max"])
    if dist["dist"] == "uniform":
        vals = lo + np.floor(u * (hi - lo + 1))
    elif dist["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(x) for x in u])
        vals = np.round(float(dist["median"]) * np.exp(float(dist["sigma"]) * z))
    elif dist["dist"] == "exponential":
        mean = (float(dist["mean"]) if "mean" in dist
                else float(dist["median"]) / np.log(2.0))
        vals = np.round(-mean * np.log1p(-u))
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.clip(vals, lo, hi).astype(np.int64)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed & SEED_MASK, stream])


class Stream:
    """Requests (and, for an open loop, their arrival gaps) in order."""

    def __init__(self, traffic: dict, vocab: int, seed: int):
        self.t = traffic
        self.vocab = vocab
        self.rng = rng_for(seed, 1)
        fixed = traffic.get("order") == "fixed"
        self.order_rng = np.random.default_rng(FIXED_ORDER) if fixed else self.rng
        self.gap_rng = np.random.default_rng(FIXED_ARRIVALS) if fixed else rng_for(seed, 4)
        self.block = int(traffic.get("block", 64))
        docs = traffic.get("documents")
        self.documents: List[List[int]] = (
            [self.rng.integers(0, vocab, size=int(docs["tokens"])).tolist()
             for _ in range(int(docs["count"]))] if docs else [])
        self.loop = traffic["loop"]
        if self.loop not in ("closed", "open"):
            raise ValueError(f"unknown loop {self.loop!r}")
        self._q: List[tuple] = []

    def _block(self, b: int, stagger: bool = False) -> List[tuple]:
        """``b`` requests of fixed joint sizes (the length and document
        quantiles paired by one fixed shuffle), in an order drawn from the
        seed or, with ``order`` fixed, the same for every seed, each with
        its gap: an open loop's independent exponential draws (from the
        seed, or with ``order`` fixed one replayed draw), else 0.
        ``stagger`` scales the outputs by evenly spaced factors in (0, 1],
        paired the same fixed way."""
        rng = self.rng
        fixed = np.random.default_rng(FIXED_PAIRING)
        plens = quantiles(self.t["prompt"], b)
        outs = fixed.permutation(quantiles(self.t["output"], b))
        docs = fixed.permutation(np.arange(b) % max(1, len(self.documents)))
        if self.loop == "open":
            gaps = self.gap_rng.standard_exponential(b) / float(self.t["rate_per_s"])
        else:
            gaps = np.zeros(b)
        if stagger:
            lo = max(1, int(self.t["output"]["min"]) // 4)
            scale = fixed.permutation((np.arange(b) + 1.0) / b)
            outs = np.maximum(lo, np.ceil(outs * scale)).astype(np.int64)
        out = []
        for k, i in enumerate(self.order_rng.permutation(b)):
            body = rng.integers(0, self.vocab, size=int(plens[i])).tolist()
            doc = self.documents[int(docs[i])] if self.documents else []
            out.append((Spec(doc + body, int(outs[i]), len(doc)), float(gaps[k])))
        return out

    def next(self) -> tuple:
        """(Spec, seconds since the previous arrival; 0 for a closed loop)."""
        if not self._q:
            self._q = self._block(self.block)[::-1]
        return self._q.pop()

    def first_round(self, clients: int) -> List[Spec]:
        """A closed loop's first ``clients`` requests: a block of their own,
        outputs staggered so that the first finishes are spread out."""
        return [s for s, _ in self._block(clients, stagger=True)]


def stream(traffic: dict, vocab: int, seed: int, rate: Optional[float] = None) -> Stream:
    """The cell's request stream; ``rate`` overrides an open loop's rate
    (the knee sweep)."""
    if rate is not None:
        traffic = dict(traffic, rate_per_s=rate)
    return Stream(traffic, vocab, seed)
