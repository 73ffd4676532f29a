"""The one generator of every traffic mix: a traffic file holds numbers
only (lengths, counts, batch), and these functions turn them and the
run's seed into inputs.

Serving: a standing backlog of requests, served first come first served,
so that a slot that frees takes the next at once, as a closed loop of as
many clients as slots would. The set of sizes is fixed by the file:
blocks of ``block`` requests whose prompt lengths are the block's
quantiles of a log-normal (median, sigma, clipped) and whose output
lengths are spread evenly over [min, max]. The seed shuffles each block
and draws the token ids, so every seed serves the same work in another
order. Training: every step's batch is ``global_batch`` rows of
``seq_len + 1`` token ids uniform over the vocabulary, the labels the
ids shifted by one."""

from __future__ import annotations

import math
import random
import statistics

import torch

from portbench.harness import common


def prompt_lengths(p: dict) -> list[int]:
    """The block's prompt lengths: log-normal quantiles, clipped."""
    nd = statistics.NormalDist()
    n = p["block"]
    out = []
    for i in range(n):
        z = nd.inv_cdf((i + 0.5) / n)
        v = int(round(p["median"] * math.exp(p["sigma"] * z)))
        out.append(min(p["max"], max(p["min"], v)))
    return out


def output_lengths(o: dict, n: int) -> list[int]:
    span = o["max"] - o["min"]
    return [o["min"] + (span * i) // max(n - 1, 1) for i in range(n)]


def serve_requests(t: dict, vocab: int, seed: int) -> list[tuple]:
    """[(prompt ids tuple, max_new)] of the backlog, in serving order."""
    p, o = t["prompt"], t["output"]
    plens = prompt_lengths(p)
    olens = output_lengths(o, p["block"])
    rng = random.Random(common.gen_seed(seed, 2))
    g = torch.Generator().manual_seed(common.gen_seed(seed, 3))
    out = []
    for _ in range(t["backlog"] // p["block"]):
        pl, ol = plens[:], olens[:]
        rng.shuffle(pl)
        rng.shuffle(ol)
        for a, b in zip(pl, ol):
            ids = torch.randint(1, vocab, (a,), generator=g)
            out.append((tuple(ids.tolist()), b))
    return out


def train_batch(t: dict, vocab: int, seed: int, step: int, device) -> dict:
    g = torch.Generator(device=device)
    g.manual_seed(common.gen_seed(seed, 1000 + step))
    ids = torch.randint(0, vocab, (t["global_batch"], t["seq_len"] + 1),
                        generator=g, device=device, dtype=torch.int64)
    return {"tokens": ids[:, :-1].to(torch.int32).contiguous(),
            "labels": ids[:, 1:].to(torch.int32).contiguous()}
