"""Deterministic, restart-exact data pipeline (port of
`repro/data/pipeline.py`; numpy only, so its batches equal the
reference's bit for bit).

Batch ``i`` is a pure function of ``(seed, step, shard)``: a restarted job
regenerates exactly the token stream it would have seen, so
checkpoint-resume needs no pipeline state. Two backends: a synthetic
corpus (zipfian unigrams with document boundaries) and a memory-mapped
uint32 token file. `make_global_array` places a host batch's rows over a
mesh's data positions (`launch.shardings.Placed`).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    backend: str = "synthetic"     # synthetic | tokenfile
    path: str = ""                 # tokenfile backend: uint32 .bin file
    zipf_a: float = 1.2            # synthetic: zipf exponent
    doc_len_mean: int = 512


def _shard_rng(cfg: DataConfig, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, shard]))


def synthetic_batch(cfg: DataConfig, step: int, shard: int, n_shards: int):
    """-> tokens uint32 [local_batch, seq_len]; deterministic in
    (cfg, step, shard)."""
    local = cfg.global_batch // n_shards
    rng = _shard_rng(cfg, step, shard)
    # zipfian unigrams with doc boundaries (token 0 = BOS)
    z = rng.zipf(cfg.zipf_a, size=(local, cfg.seq_len)).astype(np.uint32)
    toks = np.minimum(z, cfg.vocab - 1)
    doc_starts = rng.random((local, cfg.seq_len)) < (1.0 / cfg.doc_len_mean)
    toks[doc_starts] = 0
    toks[:, 0] = 0
    return toks


def tokenfile_batch(cfg: DataConfig, step: int, shard: int, n_shards: int):
    local = cfg.global_batch // n_shards
    data = np.memmap(cfg.path, dtype=np.uint32, mode="r")
    n_seq = len(data) // (cfg.seq_len + 1)
    rng = _shard_rng(cfg, step, shard)
    idx = rng.integers(0, n_seq, size=local)
    return np.stack([data[i * (cfg.seq_len + 1):
                          i * (cfg.seq_len + 1) + cfg.seq_len] for i in idx])


def host_batch(cfg: DataConfig, step: int, shard: int, n_shards: int):
    """{"tokens", "labels"} int32 [local_batch, seq_len]; labels are the
    tokens shifted left by one (wrapping)."""
    fn = {"synthetic": synthetic_batch,
          "tokenfile": tokenfile_batch}[cfg.backend]
    toks = fn(cfg, step, shard, n_shards)
    return {"tokens": toks.astype(np.int32),
            "labels": np.concatenate([toks[:, 1:], toks[:, :1]], axis=1
                                     ).astype(np.int32)}


def make_global_array(local_batches: dict, mesh, pspec) -> dict:
    """Place a host batch's rows over the mesh's data positions (the
    reference's ``make_array_from_process_local_data`` under
    ``NamedSharding(mesh, pspec)``): each array becomes a tensor on the
    mesh's first device, laid out by ``pspec`` as a
    `launch.shardings.Placed` whose pieces on that device are views of it
    (a single process holds the whole global batch, as in the reference's
    single-host run)."""
    import torch

    from repro_torch.launch.shardings import place

    dev = mesh.devices[0]

    def one(x):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        return place(t.to(dev), pspec, mesh, views=True)

    return {k: one(v) for k, v in local_batches.items()}


class DataIterator:
    """Step-indexed iterator facade (the object the train loop holds)."""

    def __init__(self, cfg: DataConfig, n_shards: int = 1, shard: int = 0,
                 start_step: int = 0):
        self.cfg = cfg
        self.n_shards = n_shards
        self.shard = shard
        self.step = start_step

    def __iter__(self):
        return self

    def __next__(self):
        b = host_batch(self.cfg, self.step, self.shard, self.n_shards)
        self.step += 1
        return b

    def state(self) -> dict:
        return {"step": self.step}      # the ONLY pipeline state — by design

    def restore(self, state: dict):
        self.step = int(state["step"])
