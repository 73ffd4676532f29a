"""ServeEngine: request-level continuous batching over a programmed AIMC
model (PyTorch port of the single-device `ServeEngine` of
`repro/runtime/engine.py`).

  request lifecycle   queued -> admitted -> prefilled -> [slot i] decoding
                      -> retired (EOS / length / max_seq cap) -> slot reused

  slot state machine  a fixed batch of ``n_slots`` decode lanes. Prefill runs
                      per request at one padded shape [1, prompt_pad]
                      (ragged prompts via ``valid_len``); its KV cache is
                      written into a free lane at the request's own length,
                      and the dense decode batch advances every lane at
                      once — retired/free lanes compute but are bit-frozen
                      (`mask_batch_select`).

  chunked decode      a dispatch advances a ladder length of steps (every
                      power of two up to ``decode_chunk``, and
                      ``decode_chunk``). The retirement predicates (max_new /
                      EOS / max_seq cap) run on the device, so the active
                      mask and per-lane counters never leave it mid-chunk;
                      the host reads ONE [n, 3, n_slots] block per chunk.
                      `serve()` double-buffers: chunk i+1 is launched before
                      chunk i's block is read.

  paged KV            (``page_size > 0``, DESIGN.md §15) the slot cache is a
                      pool of [P]-row pages behind a page table
                      (`runtime.pages`); a decode step gathers the dense
                      view, runs the same ragged `decode_step` and scatters
                      each lane's written row back — bit-equal to the dense
                      cache. ``prefix_cache`` reuses resident full prompt
                      pages by content hash (the shared span is prefilled
                      and billed once); ``prefill_chunk`` runs prefills as
                      bounded legs writing pages in place, interleaved with
                      decode chunks.

  recurrent state     (xlstm, rglru) each lane holds an O(1) state tree
                      (batch on dim 1 of every leaf, ``"len"`` on dim 0)
                      and no max_seq cap applies. With ``page_size > 0``
                      "paging" means snapshot pages: prefills run as legs
                      advancing a carried [1, ...] state, a page-aligned
                      leg end stores the whole state in one page of a
                      snapshot pool, and ``prefix_cache`` restores the
                      deepest resident snapshot of a prompt's prefix.

  shape stability     the reference compiles each closure once and asserts
                      it; in eager PyTorch `compile_counts` counts the
                      distinct (closure, input shapes) pairs each closure
                      has seen, with the reference's keys, so "nothing new
                      after warmup" stays pinned.

CM_* accounting: every useful token vector (prompt tokens at prefill, one
vector per decode step a request rides in) is booked to its request;
`batcher.reconcile` proves the per-request ledgers sum exactly to
``program.mvm_counts().scaled(observed_vectors)``.

`static_generate` is the reference's monolithic loop (one synchronized
batch, lockstep decode): the engine's bit-equality oracle and A/B baseline.
`static_prefill_closure` / `static_decode_closure` are the model-facing
math of `launch.steps`' prefill and decode cells (every family; the
enc-dec audio family is served only there: the engine refuses it, as the
reference's does).

Resilience (DESIGN.md §14): at every chunk boundary `_resilience_tick`
fires due chaos events (`runtime.chaos`), ages the installed states on the
serve clock, probes them and hot-reprograms failing cores
(`runtime.health`). It runs between dispatches, so a chunk in flight keeps
the tree it was launched with; its wall is billed to ``wall_health_s``,
not to decode. ``heartbeat`` beats a liveness file once per chunk.

Rotation (DESIGN.md §16): a `core.placement.RotationPlan` time-multiplexes
analog layer groups through a tile budget the model exceeds. The engine
holds one uncapped program and one installed tree per rotation state
(`AimcProgram.install_subset`; a layer outside a state serves digitally
from its raw weight), and `_placement_tick` advances the state at chunk
boundaries, billing each swap's incoming group as CM_INITIALIZE
(`placement.reconcile_swaps`).

Sharded serving (DESIGN.md §11): `ShardedServeEngine` lays the same
engine out on a `launch.mesh.Mesh` of positions. Programmed states become
column pieces over the ``model`` axis (one kernel launch per piece, all
with the one DAC scale), digital leaves replicate, and each lane's cache
rows, token row and retirement rows live on its ``data`` position between
chunks; a decode chunk gathers the lanes once, runs one forward per step
over every lane and scatters them back, so its tokens equal this engine's
bit for bit. Per-data-position compute (a cross-position DAC max and
batch-invariant reductions) is not done: it needs a host with more than
one card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.core.placement import SwapEvent
from repro_torch.core.program import installed_entries
from repro_torch.core.schedule import CoreSchedule
from repro_torch.models.layers import Execution, mask_batch_select
from repro_torch.runtime import chaos as chaos_lib
from repro_torch.runtime.batcher import (Batcher, Request, RequestRecord,
                                         SlotAllocator, percentile)
from repro_torch.runtime.fault_tolerance import (StragglerMonitor,
                                                 resilient_step)
from repro_torch.runtime.health import RecalEvent
from repro_torch.runtime.pages import (SCRATCH, PageAllocator, PrefixCache,
                                       page_keys)

RECURRENT_MODULES = ("xlstm", "rglru")


# ---------------------------------------------------------------------------
# closure builders: the model-facing math, shared with launch.steps
# ---------------------------------------------------------------------------

def _next_tok(logits):
    return logits.argmax(-1).to(torch.int32)


def static_prefill_closure(model, cfg, exe: Execution, *, family: str = "lm",
                           module: str = "transformer", max_seq: int,
                           cache_dtype) -> Callable:
    """(params, batch dict) -> (next_tok [B, 1] int32, cache): the
    static-batch prefill of `launch.steps.make_prefill_step`, for the audio
    (enc-dec: ``frames`` and ``tokens``), vlm (``patch_embeds``),
    transformer and recurrent families. A recurrent prefill is forward-only
    and returns an empty cache, as the reference's (the engine's
    per-request prefill fills the slot state). Runs without autograd."""
    if family == "audio":
        def run(params, batch):
            return model.prefill(params, batch["frames"], batch["tokens"],
                                 cfg, exe, max_seq=max_seq,
                                 cache_dtype=cache_dtype)
    elif family == "vlm":
        def run(params, batch):
            return model.prefill(params, batch["tokens"], cfg, exe,
                                 max_seq=max_seq,
                                 patch_embeds=batch["patch_embeds"],
                                 cache_dtype=cache_dtype)
    elif module == "transformer":
        def run(params, batch):
            return model.prefill(params, batch["tokens"], cfg, exe,
                                 max_seq=max_seq, cache_dtype=cache_dtype)
    else:
        def run(params, batch):
            logits, _ = model.forward(params, batch["tokens"], cfg, exe)
            return logits[:, -1:], ()

    @torch.no_grad()
    def prefill(params, batch):
        logits, cache = run(params, batch)
        return _next_tok(logits), cache
    return prefill


def static_decode_closure(model, cfg, exe: Execution) -> Callable:
    """(params, cache, tokens [B, 1]) -> (next_tok [B, 1] int32, cache):
    the lockstep decode step `launch.steps.make_serve_step` builds."""
    @torch.no_grad()
    def serve_step(params, cache, tokens):
        logits, new_cache = model.decode_step(params, cache, tokens, cfg, exe)
        return _next_tok(logits), new_cache
    return serve_step


@dataclasses.dataclass
class ServeReport:
    """Everything one `ServeEngine.serve` run produced."""
    records: dict[int, RequestRecord]
    n_steps: int = 0               # decode batch steps executed
    n_prefills: int = 0
    idle_vectors: int = 0          # frozen decode lanes (slot-idle waste)
    prefill_pad_vectors: int = 0   # prompt-padding lanes (prefill waste)
    # useful vectors counted from the device loop (prompt lengths at each
    # prefill + the per-step active lanes read back with each chunk),
    # independent of the per-request books — reconcile compares the two
    observed_vectors: int = 0
    wall_prefill_s: float = 0.0
    wall_decode_s: float = 0.0
    makespan_s: float = 0.0        # engine clock: last retirement - start
    retries: int = 0
    stragglers: list = dataclasses.field(default_factory=list)
    # paged serving books: prefix reuse, prefill legs, and the page-pool
    # ledger taken at finish() (`page_ledger_exact` is the allocator's
    # exact-partition verify())
    prefix_hits: int = 0           # admissions that reused >= 1 page
    prefix_hit_vectors: int = 0    # prompt vectors NOT re-prefilled
    prefill_chunks: int = 0        # prefill legs executed
    page_evictions: int = 0
    page_ledger: dict = dataclasses.field(default_factory=dict)
    page_ledger_exact: bool = True
    # drift-aware serving books (runtime.health / runtime.chaos): probes
    # run, faults fired, hot recalibrations and the CM_INITIALIZE writes
    # they charged (reconciled by health.reconcile_recal); wall_health_s is
    # the probe+repair wall, billed apart from decode
    probes: int = 0
    n_recals: int = 0
    recal_initialize: int = 0
    recal_events: list = dataclasses.field(default_factory=list)
    fault_events: list = dataclasses.field(default_factory=list)
    wall_health_s: float = 0.0
    # capacity-overflow rotation books (core.placement): swaps performed,
    # the CM_INITIALIZE writes they charged (`reprogram_counts` of each
    # swap's incoming group, closed by placement.reconcile_swaps) and the
    # host wall spent swapping (billed apart from decode)
    n_swaps: int = 0
    swap_initialize: int = 0
    swap_events: list = dataclasses.field(default_factory=list)
    wall_swap_s: float = 0.0

    @property
    def useful_vectors(self) -> int:
        return sum(r.vectors for r in self.records.values())

    @property
    def generated_tokens(self) -> int:
        return sum(len(r.tokens) for r in self.records.values())

    def tokens(self, rid: int) -> list[int]:
        return self.records[rid].tokens

    def latency_percentiles(self, qs=(50, 99)) -> dict[str, float]:
        lats = [r.latency for r in self.records.values()]
        ttfts = [r.ttft for r in self.records.values()]
        out = {}
        for q in qs:
            out[f"p{q}_latency_s"] = percentile(lats, q)
            out[f"p{q}_ttft_s"] = percentile(ttfts, q)
        return out

    def summary(self) -> str:
        gen = self.generated_tokens
        wall = self.wall_prefill_s + self.wall_decode_s
        pct = self.latency_percentiles()
        return (f"{len(self.records)} requests, {gen} tokens in "
                f"{self.makespan_s:.2f}s engine-time ({gen / max(wall, 1e-9):.1f}"
                f" tok/s compute; {self.n_prefills} prefills, {self.n_steps} "
                f"decode steps, {self.idle_vectors} idle lanes); "
                f"p50/p99 latency {pct['p50_latency_s']:.2f}/"
                f"{pct['p99_latency_s']:.2f}s")


@dataclasses.dataclass
class EngineSession:
    """Host-side state of one in-flight serving run (created by
    `ServeEngine.begin()`, driven only by its engine's primitives).
    ``state`` holds the device-resident per-lane retirement rows
    {active, gen, pos, max_new}, each [n_slots]."""
    report: ServeReport
    slots: SlotAllocator
    slot_rec: dict[int, RequestRecord]
    cache: dict
    tok_buf: torch.Tensor
    state: dict
    retries0: int
    flagged0: int
    # host projection of each busy lane's remaining decode budget (slot ->
    # steps); EOS may retire a lane earlier than projected, never later
    rem: dict[int, int] = dataclasses.field(default_factory=dict)
    # (record, first-token tensor) pairs not read yet: with no EOS nothing
    # about admission depends on the value, so the read waits for the next
    # chunk sync instead of stalling the host behind the device
    lazy: list = dataclasses.field(default_factory=list)
    # paged serving: queued prefill jobs (FIFO, one leg per serve-loop
    # iteration), each busy slot's pages as (owned pids, shared-hit pids),
    # and the prefix-cache counters at begin()
    jobs: list = dataclasses.field(default_factory=list)
    slot_pages: dict = dataclasses.field(default_factory=dict)
    evictions0: int = 0


# retirement codes emitted by the decode loop (0 = still running)
_REASONS = {1: "length", 2: "eos", 3: "cap"}
CACHE_DTYPE = torch.float32    # KV cache
PAD_ID = 0                     # prompt right-padding token
MAX_RETRIES = 2                # transient decode failures retried
STRAGGLER_THRESHOLD = 3.0      # chunk slower than 3x the EWMA is flagged


@dataclasses.dataclass
class _PendingChunk:
    """One launched decode chunk: its [n, 3, S] output block (tokens,
    active-at-entry, reason) and the dispatch-time clock marks."""
    ys: torch.Tensor
    t_wall: float
    prefill0: float
    n: int
    health0: float = 0.0   # report.wall_health_s at dispatch (overlap bill)
    recals0: int = 0       # report.n_recals at dispatch (straggler exemption)
    swap0: float = 0.0     # report.wall_swap_s at dispatch (overlap bill)
    swaps0: int = 0        # report.n_swaps at dispatch (straggler exemption)


@dataclasses.dataclass
class _PrefillJob:
    """One admitted request whose legged prefill has not finished. The
    slot is held for the job's whole life (its decode lane stays inactive)
    until `_finalize_job` registers the page-table row (transformer) or
    inserts the carried state (recurrent) and arms the lane."""
    req: Request
    rec: RequestRecord
    slot: int
    legs: list                # [(pos0, span, tokens [1, C])] in order
    pt_row: torch.Tensor | None   # device [M] int32 page-table row
    keys: list
    f_eff: int = 0            # pages (or snapshot depth) reused
    leg_i: int = 0
    tok1: torch.Tensor | None = None   # [1, 1] first token of the last leg
    carry: dict | None = None          # recurrent: state carried by the legs

    @property
    def done(self) -> bool:
        return self.leg_i >= len(self.legs)


def _signature(x):
    """Shape signature of a closure input: tensors (and a mesh's placed
    tensors) by shape and dtype, containers by their items, host scalars by
    type (the reference traces them as scalars)."""
    if isinstance(x, torch.Tensor) or hasattr(x, "pieces"):
        return tuple(x.shape), x.dtype
    if isinstance(x, dict):
        return tuple((k, _signature(v)) for k, v in sorted(x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_signature(v) for v in x)
    return type(x).__name__


def _batch_dim(name: str) -> int:
    """Batch dim of a slot-cache leaf: dim 1 under the layer stack for KV
    and recurrent state alike, dim 0 for the per-row lengths."""
    return 0 if name == "len" else 1


def _wait(t: torch.Tensor):
    """Block the host until the device has produced ``t``."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


class ServeEngine:
    """Continuous-batching serving engine over one (installed) model.

    ``params`` carries installed `AimcLinearState`s for the programmed AIMC
    path (``program.install(params)``); pass the `AimcProgram` as
    ``program`` for CM_* ledger reconciliation (and its ``schedule``,
    which follows the program through a remap). Everything runs on the
    device of ``params["embed"]``; ``eos_id`` retires a lane when it emits
    that token (the token is control, not payload). ``health``
    (`runtime.health.HealthMonitor`), ``chaos``
    (`runtime.chaos.FaultInjector`) and ``heartbeat``
    (`fault_tolerance.Heartbeat`) act at chunk boundaries. ``rotation``
    (a `core.placement.RotationPlan`) with ``rotation_params`` (one
    installed tree per state, ``program.install_subset``) serves a model
    larger than its tile budget, swapping states at chunk boundaries."""

    def __init__(self, model, cfg, exe: Execution, params, *,
                 n_slots: int = 4, prompt_pad: int = 16, max_seq: int = 64,
                 cache_dtype=CACHE_DTYPE, family: str = "lm",
                 module: str = "transformer", program=None, schedule=None,
                 eos_id: int | None = None, admission: str = "fifo",
                 decode_chunk: int = 1, page_size: int = 0,
                 n_pages: int = 0, prefix_cache: bool = False,
                 prefill_chunk: int = 0, health=None, chaos=None,
                 heartbeat=None, rotation=None, rotation_params=None):
        if family == "audio":
            raise ValueError("ServeEngine serves decoder-only LMs; the "
                             "enc-dec audio family decodes via launch.steps")
        if prompt_pad > max_seq:
            raise ValueError(f"prompt_pad {prompt_pad} > max_seq {max_seq}")
        if family == "vlm" and prompt_pad < cfg.n_patches:
            raise ValueError(
                f"vlm prompts start with {cfg.n_patches} patch positions; "
                f"prompt_pad {prompt_pad} cannot hold them")
        if decode_chunk < 1:
            raise ValueError(f"decode_chunk must be >= 1, got {decode_chunk}")
        self.model, self.cfg, self.exe, self.params = model, cfg, exe, params
        self.device = params["embed"].device
        self.n_slots, self.prompt_pad, self.max_seq = n_slots, prompt_pad, max_seq
        self.cache_dtype = cache_dtype
        self.family, self.module = family, module
        self.program, self.schedule = program, schedule
        self.eos_id = eos_id
        self.admission = admission
        self.decode_chunk = decode_chunk
        self._ladder = self.chunk_ladder(decode_chunk)

        # ---- paged KV / prefix cache / chunked prefill (DESIGN.md §15) ----
        if page_size < 0 or n_pages < 0 or prefill_chunk < 0:
            raise ValueError("page_size / n_pages / prefill_chunk >= 0")
        if (prefix_cache or prefill_chunk) and page_size == 0:
            raise ValueError("prefix_cache / prefill_chunk require "
                             "page_size > 0")
        if page_size > max_seq:
            raise ValueError(f"page_size {page_size} > max_seq {max_seq}")
        self.recurrent = module in RECURRENT_MODULES
        self.page_size = page_size
        self.prefill_chunk = prefill_chunk
        # _paged_kv: the slot KV cache lives in a page pool behind a page
        # table; _use_legs: prefill runs as legs writing pages directly
        # (both the prefix cache and chunked prefill need them). Recurrent
        # archs carry O(1) state, so for them paging means snapshot pages
        # (_snap: one page holds a whole [1, ...] state at a page boundary)
        # and prefill legs advancing a carried state (_legs_rec).
        self._paged_kv = page_size > 0 and not self.recurrent
        self._legs_rec = (self.recurrent and page_size > 0
                          and (prefix_cache or prefill_chunk > 0))
        self._snap = self._legs_rec and prefix_cache
        self._use_legs = self._paged_kv and (prefix_cache or prefill_chunk > 0)
        self._chunked = prefill_chunk > 0
        if self._paged_kv and module != "transformer":
            raise ValueError(f"paged KV serves the transformer module; "
                             f"got {module!r}")
        self._pt_width = -(-max_seq // page_size) if self._paged_kv else 0
        if self._use_legs:
            if family == "vlm":
                raise ValueError(
                    "prefix_cache / prefill_chunk cannot serve vlm (patch "
                    "embeds cannot ride a chunked prefill leg)")
            if getattr(cfg, "is_moe", False):
                raise ValueError(
                    "prefix_cache / prefill_chunk cannot serve MoE models: "
                    "capacity-factor routing mixes positions, so a chunked "
                    "prefill is not bit-equal to the dense one")
            if cache_dtype != torch.float32:
                raise ValueError(
                    "prefix_cache / prefill_chunk require cache_dtype "
                    "float32: a page read back by a sharer must be bit-"
                    "identical to what the producing leg computed")
        if self._snap and self._chunked and prefill_chunk % page_size:
            raise ValueError(
                "recurrent prefix_cache requires prefill_chunk to be a "
                "multiple of page_size (snapshots are taken at leg ends, "
                "which must land on page boundaries)")
        self.pages = None
        self.prefix = None
        self._pool = None        # engine-lifetime (kp, vp) pool tensors
        self._pool_snap = None   # engine-lifetime recurrent snapshot pool
        if self._paged_kv or self._snap:
            if n_pages == 0:
                n_pages = (n_slots * self._pt_width + 1
                           + (self._pt_width if prefix_cache else 0)
                           if self._paged_kv
                           else 1 + n_slots * max(1, prompt_pad // page_size))
            if self._paged_kv and n_pages < self._pt_width + 1:
                raise ValueError(
                    f"n_pages {n_pages} cannot hold one max-length request "
                    f"({self._pt_width} pages + scratch): admission would "
                    f"deadlock on an empty engine")
            self.pages = PageAllocator(n_pages, page_size)
            self.prefix = PrefixCache(self.pages) if prefix_cache else None
        # leg width: transformer legs default to one full-prompt leg,
        # recurrent legs to one page (snapshot boundaries = leg ends)
        self._leg_c = ((prefill_chunk or prompt_pad) if not self.recurrent
                       else (prefill_chunk or page_size))

        self.monitor = StragglerMonitor(threshold=STRAGGLER_THRESHOLD)
        self._retries = 0
        self._step_no = 0
        self._chunks_dispatched = 0    # lifetime chunk counter (chaos clock)
        self.health, self.chaos, self.heartbeat = health, chaos, heartbeat
        if health is not None:
            if program is None:
                raise ValueError("health monitoring requires an AimcProgram")
            if tuple(health.program.names) != tuple(program.names):
                raise ValueError("health monitor was built for a different "
                                 "program (matrix names mismatch)")
        if chaos is not None and health is None:
            raise ValueError("chaos injection requires a HealthMonitor to "
                             "detect and repair the faults it fires")
        # capacity-overflow rotation: one installed tree per state, all
        # warmed in `warmup`; `_placement_tick` swaps them
        self.rotation = rotation
        self._rotation_params = (tuple(rotation_params)
                                 if rotation_params is not None else None)
        self._rot_state = 0
        self._swaps_done = 0
        if rotation is not None:
            if program is None:
                raise ValueError("rotation serving requires the backing "
                                 "AimcProgram (swap billing is shape-based)")
            if (self._rotation_params is None
                    or len(self._rotation_params) != rotation.n_states):
                got = (len(self._rotation_params)
                       if self._rotation_params is not None else None)
                raise ValueError(
                    f"rotation needs one installed parameter tree per "
                    f"state ({rotation.n_states}), got {got}")
            if health is not None or chaos is not None:
                raise ValueError(
                    "rotation cannot combine with health/chaos: a hot "
                    "recal would repair only the current state's tree")
            if prefix_cache or prefill_chunk:
                raise ValueError(
                    "rotation cannot combine with prefix_cache / "
                    "prefill_chunk: a cached span replayed under a "
                    "different rotation state would not be bit-stable")
            self.params = self._rotation_params[0]
        # model forward passes run by this engine, warmup included (each
        # prefill, prefill leg and decode step is one pass over every layer;
        # a recurrent prefill or leg scans the decode step, one pass per
        # token position it covers, padding included)
        self.forward_passes = 0
        # closure name -> distinct input signatures seen (compile_counts)
        self._seen: dict[str, set] = {}
        decode = self._decode_paged_fn if self._paged_kv else self._decode_fn
        self._safe_decodes = {
            n: resilient_step(decode, max_retries=MAX_RETRIES,
                              on_retry=lambda attempt, e: self._count_retry())
            for n in self._ladder}

    @staticmethod
    def chunk_ladder(k: int) -> tuple[int, ...]:
        """The chunk lengths a dispatch may use: every power of two up to
        ``k``, plus ``k``."""
        ladder = {1, k}
        p = 2
        while p < k:
            ladder.add(p)
            p *= 2
        return tuple(sorted(ladder))

    def _note(self, closure: str, *args, static=None):
        self._seen.setdefault(closure, set()).add((static, _signature(args)))

    def compile_counts(self) -> dict[str, int]:
        """Distinct input signatures each device closure has seen, under
        the reference's keys. After `warmup`, serving any trace must leave
        prefill/insert at 1 and decode at ``len(chunk_ladder)``, plus
        prefill_chunk (and register, transformer) at 1 when prefills run as
        legs, and snapshot/restore at 1 with recurrent snapshot pages."""
        def n(name):
            return len(self._seen.get(name, ()))
        counts = {"prefill": n("prefill"),
                  "insert": n("insert_paged" if self._paged_kv else "insert"),
                  "decode": n("decode")}
        if self._use_legs:
            counts["prefill_chunk"] = n("prefill_chunk")
            counts["register"] = n("register")
        if self._legs_rec:
            counts["prefill_chunk"] = n("prefill_chunk")
        if self._snap:
            counts["snapshot"] = n("snapshot")
            counts["restore"] = n("restore")
        return counts

    # -- device functions ----------------------------------------------------
    def _prefill_fn(self, tokens, valid_len):
        """[1, prompt_pad] ragged prefill -> (first_tok [1,1], cache1)."""
        # each rotation state's tree is an executable of its own in the
        # reference: its shapes are keyed by the state
        self._note("prefill", tokens, valid_len, static=self._rot_state)
        kw = {}
        if self.family == "vlm":
            # patch positions are a prompt prefix; the engine serves the
            # text path with zero patch embeddings (frontend-stub rule)
            kw["patch_embeds"] = torch.zeros(
                (tokens.shape[0], self.cfg.n_patches, self.cfg.d_model),
                dtype=torch.float32, device=tokens.device)
        logits, cache = self.model.prefill(
            self.params, tokens, self.cfg, self.exe, max_seq=self.max_seq,
            cache_dtype=self.cache_dtype, valid_len=valid_len, **kw)
        self.forward_passes += tokens.shape[1] if self.recurrent else 1
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        return tok, cache

    @staticmethod
    def _arm(sess: EngineSession, tok1, slot: int, pos0: int, max_new: int):
        """Point decode lane ``slot`` at its first token and retirement row
        (gen starts at 1: the prefill's token counts against max_new)."""
        sess.tok_buf[slot] = tok1[0]
        st = sess.state
        st["active"][slot] = True
        st["gen"][slot] = 1
        st["pos"][slot] = pos0
        st["max_new"][slot] = max_new

    def _insert(self, sess: EngineSession, cache1, tok1, slot: int,
                pos0: int, max_new: int):
        """Write a prefilled request into decode lane ``slot``, in place on
        the session's tensors (stream-ordered after any chunk already
        launched on them)."""
        self._note("insert", sess.cache, cache1, tok1)
        for name, leaf in sess.cache.items():
            dim = _batch_dim(name)
            leaf.select(dim, slot).copy_(cache1[name].select(dim, 0))
        self._arm(sess, tok1, slot, pos0, max_new)

    def _insert_paged(self, sess: EngineSession, cache1, tok1, slot: int,
                      pos0: int, max_new: int, pt_row, write_mask):
        """Paged insert of a DENSE [1, max_seq] prefill cache: scatter it
        into this request's pages and point the slot's page-table row at
        them. ``write_mask`` keeps the allocated table entries; masked-off
        pages (prompt padding never read) route to the scratch page."""
        self._note("insert_paged", sess.cache, cache1, tok1, pt_row,
                   write_mask)
        pids = torch.where(write_mask, pt_row, torch.zeros_like(pt_row))
        cache = sess.cache
        cache["kp"][:, pids] = self._to_pages(cache1["k"], cache["kp"].dtype)
        cache["vp"][:, pids] = self._to_pages(cache1["v"], cache["vp"].dtype)
        cache["pt"][slot] = pt_row
        cache["len"][slot] = pos0
        self._arm(sess, tok1, slot, pos0, max_new)

    def _to_pages(self, leaf, dtype):
        """A dense [L, 1, max_seq, H, hd] prefill cache leaf as the
        request's page-table row of pages, [L, M, page_size, H, hd]."""
        p, m = self.page_size, self._pt_width
        x = leaf[:, 0].to(dtype)                    # [L, max_seq, H, hd]
        if m * p != self.max_seq:
            x = torch.nn.functional.pad(
                x, (0, 0, 0, 0, 0, m * p - self.max_seq))
        return x.reshape(x.shape[0], m, p, *x.shape[2:])

    def _register(self, sess: EngineSession, tok1, slot: int, pos0: int,
                  max_new: int, pt_row):
        """Arm a slot whose pages prefill legs filled in place: only the
        page-table row, the length and the lane's rows change."""
        self._note("register", sess.cache["pt"], sess.cache["len"], tok1,
                   pt_row)
        sess.cache["pt"][slot] = pt_row
        sess.cache["len"][slot] = pos0
        self._arm(sess, tok1, slot, pos0, max_new)

    def _leg_fn(self, tokens, kp, vp, pt_row, pos0: int, span: int):
        """One prefill leg writing straight into the page pools."""
        self._note("prefill_chunk", tokens, kp, vp, pt_row, pos0, span)
        out = self.model.prefill_chunk(
            self.params, tokens, self.cfg, self.exe, kp, vp, pt_row, pos0,
            span, page_size=self.page_size, context_len=self.prompt_pad)
        self.forward_passes += 1
        return out

    def _leg_rec_fn(self, cache, tokens, span: int):
        """One recurrent prefill leg advancing a carried [1, ...] state."""
        self._note("prefill_chunk", cache, tokens, span)
        logits, cache = self.model.prefill_chunk(
            self.params, cache, tokens, self.cfg, self.exe, span)
        self.forward_passes += tokens.shape[1]
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        return tok, cache

    def _snap_put_fn(self, pool, cache1, pid: int):
        """Store a [1, ...] recurrent state into snapshot page ``pid``, in
        place."""
        self._note("snapshot", pool, cache1, pid)
        for name, leaf in pool.items():
            dim = _batch_dim(name)
            leaf.select(dim, pid).copy_(cache1[name].select(dim, 0))
        return pool

    def _snap_get_fn(self, pool, pid: int):
        """Snapshot page ``pid`` as a fresh [1, ...] state tree."""
        self._note("restore", pool, pid)
        return {name: leaf.narrow(_batch_dim(name), pid, 1).clone()
                for name, leaf in pool.items()}

    def _retire_step(self, state, tokens, logits, active):
        """The on-device retirement machine of one decode step: (tokens,
        new state, ys row [3, S])."""
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        tokens = torch.where(active[:, None], tok, tokens)
        emitted = tokens[:, 0]
        step = active.to(torch.int32)
        gen = state["gen"] + step
        pos = state["pos"] + step
        reason = torch.zeros_like(emitted)
        if not self.recurrent:
            # the KV write position is bounded by max_seq; O(1)-state
            # recurrent archs have no such cap
            reason = torch.where(pos >= self.max_seq, 3, reason)
        reason = torch.where(gen >= state["max_new"], 1, reason)
        if self.eos_id is not None:
            reason = torch.where(emitted == self.eos_id, 2, reason)
        reason = torch.where(active, reason, 0)
        state = {"active": active & (reason == 0), "gen": gen, "pos": pos,
                 "max_new": state["max_new"]}
        return tokens, state, torch.stack([emitted, step, reason])

    def _decode_fn(self, cache, tok_buf, state, length: int):
        """``length`` dense decode steps; inactive lanes are bit-frozen and
        the retirement predicates run on the device. Returns (tok_buf,
        cache, state, ys) with ys int32 [length, 3, S] = (emitted token,
        active at entry, reason) per step. Inputs are not modified."""
        self._note("decode", cache, tok_buf, state,
                   static=(length, self._rot_state))
        rows = []
        tokens = tok_buf
        kw = {} if self.recurrent else {"ragged": True}
        for _ in range(length):
            active = state["active"]
            logits, new_cache = self.model.decode_step(
                self.params, cache, tokens, self.cfg, self.exe, **kw)
            self.forward_passes += 1
            cache = {name: mask_batch_select(new_cache[name], leaf, active,
                                             _batch_dim(name))
                     for name, leaf in cache.items()}
            tokens, state, ys = self._retire_step(state, tokens, logits,
                                                  active)
            rows.append(ys)
        return tokens, cache, state, torch.stack(rows)

    def _decode_paged_fn(self, cache, tok_buf, state, length: int):
        """The paged twin of `_decode_fn`. Per step: gather the page table
        into a dense [S, max_seq] view (`model.paged_view`), run the same
        ragged `decode_step`, and scatter each lane's one written row back
        to its page; inactive lanes write to the scratch page. The rows a
        lane attends to are the dense cache's rows, so decode is bit-equal
        to the dense engine. The pools are written in place (a retried
        step rewrites the same rows); lengths, tokens and state are not."""
        self._note("decode", cache, tok_buf, state,
                   static=(length, self._rot_state))
        kp, vp, pt, lens = cache["kp"], cache["vp"], cache["pt"], cache["len"]
        p = self.page_size
        lanes = torch.arange(self.n_slots, device=pt.device)
        rows = []
        tokens = tok_buf
        for _ in range(length):
            active = state["active"]
            k_view, v_view = self.model.paged_view(kp, vp, pt, self.max_seq)
            logits, new_cache = self.model.decode_step(
                self.params, {"k": k_view, "v": v_view, "len": lens}, tokens,
                self.cfg, self.exe, ragged=True)
            self.forward_passes += 1
            row = lens.clamp(0, self.max_seq - 1).long()
            pid = pt.gather(1, (row // p)[:, None])[:, 0].long()
            spid = torch.where(active, pid, SCRATCH)
            soff = torch.where(active, row % p, 0)
            kp[:, spid, soff] = new_cache["k"][:, lanes, row].to(kp.dtype)
            vp[:, spid, soff] = new_cache["v"][:, lanes, row].to(vp.dtype)
            lens = torch.where(active, new_cache["len"], lens)
            tokens, state, ys = self._retire_step(state, tokens, logits,
                                                  active)
            rows.append(ys)
        return tokens, {"kp": kp, "vp": vp, "pt": pt, "len": lens}, state, \
            torch.stack(rows)

    # -- buffers -------------------------------------------------------------
    def _fresh_pools(self):
        pools = self.model.init_paged_cache(
            self.cfg, self.pages.n_pages, self.page_size, self.cache_dtype,
            self.device)
        return pools["kp"], pools["vp"]

    def _paged_cache_dict(self, kp, vp):
        return {"kp": kp, "vp": vp,
                "pt": torch.zeros((self.n_slots, self._pt_width),
                                  dtype=torch.int32, device=self.device),
                "len": torch.zeros((self.n_slots,), dtype=torch.int32,
                                   device=self.device)}

    def _empty_cache(self):
        if self._paged_kv:
            # the pools outlive sessions (prefix pages stay resident across
            # begin()s): they move into the session here and come back at
            # finish()
            kp, vp = self._pool if self._pool is not None \
                else self._fresh_pools()
            self._pool = None
            return self._paged_cache_dict(kp, vp)
        return self.model.init_cache(self.cfg, self.n_slots, self.max_seq,
                                     self.cache_dtype, self.device)

    def _snap_pool(self):
        """The engine-lifetime recurrent snapshot pool, made at first use:
        the slot cache's leaves with n_pages in the batch dim."""
        if self._pool_snap is None:
            self._pool_snap = self.model.init_cache(
                self.cfg, self.pages.n_pages, self.max_seq, self.cache_dtype,
                self.device)
        return self._pool_snap

    def _empty_state(self):
        def z():
            return torch.zeros((self.n_slots,), dtype=torch.int32,
                               device=self.device)
        return {"active": torch.zeros((self.n_slots,), dtype=torch.bool,
                                      device=self.device),
                "gen": z(), "pos": z(), "max_new": z()}

    def _empty_tok_buf(self):
        return torch.zeros((self.n_slots, 1), dtype=torch.int32,
                           device=self.device)

    def _session(self, cache) -> EngineSession:
        px = self.prefix
        return EngineSession(
            report=ServeReport(records={}), slots=SlotAllocator(self.n_slots),
            slot_rec={}, cache=cache, tok_buf=self._empty_tok_buf(),
            state=self._empty_state(), retries0=self._retries,
            flagged0=len(self.monitor.flagged),
            evictions0=px.evictions if px is not None else 0)

    def warmup(self) -> dict[str, int]:
        """Run every device path once (prefill, insert, the prefill leg and
        register when legged, snapshot put/restore, one chunk of each
        ladder length) outside the serving clock: kernels build and load,
        allocator pools fill. Paged engines warm on throwaway pools (every
        write of warmup goes to their scratch page anyway). Returns
        `compile_counts()`."""
        tokens = torch.zeros((1, self.prompt_pad), dtype=torch.int32,
                             device=self.device)
        vl = torch.ones((1,), dtype=torch.int32, device=self.device)
        trees = self._rotation_params or (self.params,)
        for i in reversed(range(len(trees))):   # ends on state 0
            self._use_tree(i, trees[i])
            tok1, cache1 = self._prefill_fn(tokens, vl)
        if self._paged_kv:
            sess = self._session(self._paged_cache_dict(*self._fresh_pools()))
            pt_row = torch.zeros((self._pt_width,), dtype=torch.int32,
                                 device=self.device)
            self._insert_paged(sess, cache1, tok1, 0, 1, 1, pt_row,
                               torch.zeros((self._pt_width,), dtype=torch.bool,
                                           device=self.device))
            if self._use_legs:
                leg = torch.zeros((1, self._leg_c), dtype=torch.int32,
                                  device=self.device)
                tokw, _, _ = self._leg_fn(leg, sess.cache["kp"],
                                          sess.cache["vp"], pt_row, 0, 1)
                self._register(sess, tokw, 0, 1, 1, pt_row)
        else:
            sess = self._session(self._empty_cache())
            if self._legs_rec:
                leg = torch.zeros((1, self._leg_c), dtype=torch.int32,
                                  device=self.device)
                cache1 = self.model.init_cache(self.cfg, 1, self.max_seq,
                                               self.cache_dtype, self.device)
                tok1, cache1 = self._leg_rec_fn(cache1, leg, 1)
                if self._snap:
                    # page SCRATCH of the engine's own pool: a put writes
                    # before any get reads, so nothing stale is ever served
                    pool = self._snap_put_fn(self._snap_pool(), cache1,
                                             SCRATCH)
                    self._snap_get_fn(pool, SCRATCH)
            self._insert(sess, cache1, tok1, 0, 1, 1)
        tok_buf, cache, state = sess.tok_buf, sess.cache, sess.state
        decode = self._decode_paged_fn if self._paged_kv else self._decode_fn
        for i in reversed(range(len(trees))):
            self._use_tree(i, trees[i])
            for n in self._ladder:
                tok_buf, cache, state, ys = decode(cache, tok_buf, state, n)
        ys.cpu()
        return self.compile_counts()

    def _use_tree(self, state: int, params):
        """Serve ``params`` as rotation state ``state`` (without rotation:
        state 0, the engine's own tree)."""
        self._rot_state = state
        self.params = params

    def _set_params(self, params):
        """Serve ``params``: a tree a resilience update changed (same
        shapes)."""
        self.params = params

    def _count_retry(self):
        self._retries += 1

    # -- request plumbing ----------------------------------------------------
    def _pad_prompt(self, prompt):
        if len(prompt) > self.prompt_pad:
            raise ValueError(f"prompt length {len(prompt)} exceeds "
                             f"prompt_pad {self.prompt_pad}")
        if self.family == "vlm" and len(prompt) < self.cfg.n_patches:
            # positions [0, n_patches) are patch embeddings wholesale; a
            # shorter prompt would take its "last valid" logit inside the
            # patch prefix and serve silently wrong
            raise ValueError(
                f"vlm prompt length {len(prompt)} < n_patches "
                f"{self.cfg.n_patches}: the prompt must cover the patch "
                f"positions")
        padded = list(prompt) + [PAD_ID] * (self.prompt_pad - len(prompt))
        return (torch.tensor([padded], dtype=torch.int32, device=self.device),
                torch.tensor([len(prompt)], dtype=torch.int32,
                             device=self.device))

    def _prefill_request(self, req: Request, rec: RequestRecord, lazy: bool):
        """Run the [1, prompt_pad] prefill and book its vectors. With
        ``lazy`` the host does not wait for the token (``first`` is None)."""
        tokens, vl = self._pad_prompt(req.prompt)
        t0 = time.perf_counter()
        tok1, cache1 = self._prefill_fn(tokens, vl)
        first = None if lazy else int(tok1[0, 0])
        dt = time.perf_counter() - t0
        rec.prefill_vectors = len(req.prompt)
        rec.pad_vectors = self.prompt_pad - len(req.prompt)
        return tok1, cache1, first, dt

    # -- session primitives --------------------------------------------------
    def begin(self) -> EngineSession:
        """Open a serving session: fresh slots, device buffers and books
        (a paged engine's pools, and the prefix pages in them, carry
        over)."""
        return self._session(self._empty_cache())

    @staticmethod
    def _retire(rec: RequestRecord, reason: str, at: float):
        rec.finish_reason = reason
        rec.t_done = at

    def admit(self, sess: EngineSession, req: Request, now: float,
              drain: bool = True) -> float:
        """Admit one request at clock ``now``: prefill, book, and either
        retire at prefill (max_new=1 / instant EOS) or insert into a free
        slot. Returns the advanced clock; the caller guarantees a free
        slot (and, when paged, `can_admit`). Legged admission (prefix cache
        / chunked prefill) runs every leg now with ``drain``, else queues
        the job on ``sess.jobs`` for `serve()` to advance one leg per loop
        iteration."""
        report = sess.report
        rec = RequestRecord(request=req, t_admit=now)
        report.records[req.rid] = rec
        if req.max_new > 1 and (self._use_legs or self._legs_rec):
            return self._admit_legged(sess, req, rec, now, drain)
        lazy = self.eos_id is None
        tok1, cache1, first, dt = self._prefill_request(req, rec, lazy)
        now += dt
        report.wall_prefill_s += dt
        report.n_prefills += 1
        report.prefill_pad_vectors += rec.pad_vectors
        report.observed_vectors += len(req.prompt)
        rec.t_first = now
        if lazy:
            sess.lazy.append((rec, tok1))
        elif first == self.eos_id:
            # EOS is control, not payload: never in rec.tokens, but its
            # vector stays in the CM_* books
            self._retire(rec, "eos", now)
            return now
        else:
            rec.tokens.append(first)
        if req.max_new == 1:
            self._retire(rec, "length", now)
            return now
        slot = sess.slots.alloc(req.rid)
        sess.slot_rec[slot] = rec
        sess.rem[slot] = self._decode_budget(req)
        t0 = time.perf_counter()
        if self._paged_kv:
            pt_row, mask, owned = self._alloc_pt_row(req)
            sess.slot_pages[slot] = (owned, [])
            self._insert_paged(sess, cache1, tok1, slot, len(req.prompt),
                               req.max_new, pt_row, mask)
        else:
            self._insert(sess, cache1, tok1, slot, len(req.prompt),
                         req.max_new)
        ins = time.perf_counter() - t0
        now += ins
        report.wall_prefill_s += ins
        return now

    def _decode_budget(self, req: Request) -> int:
        """Decode steps the lane may take: max_new - 1, capped by the KV
        rows left (no cap for O(1)-state recurrent archs)."""
        rem = req.max_new - 1
        if not self.recurrent:
            rem = min(rem, self.max_seq - len(req.prompt))
        return rem

    # -- paged admission (DESIGN.md §15) -------------------------------------
    def _pages_span(self, req: Request) -> tuple[int, int]:
        """(last row index + 1 this request can ever write, pages that
        cover it): rows past ``end`` are never written or read."""
        plen = len(req.prompt)
        end = plen + min(req.max_new - 1, self.max_seq - plen)
        return end, -(-end // self.page_size)

    def _alloc_pages(self, n: int, owner, protect=()):
        """``n`` pages, evicting sole-sharer prefix entries (LRU) to make
        room. Raises on a genuine shortage — `can_admit` gates callers."""
        pids = self.pages.alloc(n, owner=owner)
        if pids is None and self.prefix is not None:
            self.prefix.evict(n - self.pages.n_free, protect=protect)
            pids = self.pages.alloc(n, owner=owner)
        if pids is None:
            raise RuntimeError(
                f"page pool exhausted: {owner} needs {n} pages, "
                f"{self.pages.n_free} free (gate admission on can_admit)")
        return pids

    def _row_tensor(self, row):
        return torch.tensor(row, dtype=torch.int32, device=self.device)

    def _alloc_pt_row(self, req: Request):
        """Paged insert's page grab: all pages owned, no sharing."""
        _, n_alloc = self._pages_span(req)
        owned = self._alloc_pages(n_alloc, req.rid)
        row = owned + [SCRATCH] * (self._pt_width - n_alloc)
        mask = [j < n_alloc for j in range(self._pt_width)]
        return (self._row_tensor(row),
                torch.tensor(mask, dtype=torch.bool, device=self.device),
                owned)

    def _peek_prefix(self, prompt) -> tuple[int, list]:
        """(f_eff, hit pids) an admission WOULD reuse: the longest run of
        resident full pages, capped so the continuation keeps >= 1 token.
        Leaves LRU order and stats untouched."""
        if self.prefix is None:
            return 0, []
        got = self.prefix.lookup(page_keys(prompt, self.page_size),
                                 peek=True)
        f = 0
        while f < len(got) and got[f] is not None:
            f += 1
        f = min(f, (len(prompt) - 1) // self.page_size)
        return f, got[:f]

    def pages_needed(self, req: Request) -> int:
        """Pages an admission would NEWLY allocate: the tenant-quota unit
        (shared prefix pages are not billed to their sharers)."""
        if not self._paged_kv or req.max_new <= 1:
            return 0
        _, n_alloc = self._pages_span(req)
        f_eff, _ = self._peek_prefix(req.prompt)
        return n_alloc - f_eff

    def tenant_pages(self, sess: EngineSession, tenant_of=None) -> dict:
        """tenant -> pages held as owner across busy slots (what
        `runtime.server` charges page quotas against); ``tenant_of`` maps
        rid -> tenant, without it every request is tenant None."""
        held: dict = {}
        for slot, (owned, _shared) in sess.slot_pages.items():
            rec = sess.slot_rec.get(slot)
            if rec is None:
                continue
            t = (tenant_of.get(rec.request.rid) if tenant_of is not None
                 else None)
            held[t] = held.get(t, 0) + len(owned)
        return held

    def can_admit(self, sess: EngineSession, req: Request) -> bool:
        """Whether the page pool can cover ``req`` now (free pages plus
        cache-only entries admission may evict, minus the hit pages about
        to gain a sharer). Unpaged engines always admit."""
        if not self._paged_kv or req.max_new <= 1:
            return True
        _, n_alloc = self._pages_span(req)
        f_eff, hit_pids = self._peek_prefix(req.prompt)
        have = self.pages.n_free
        if self.prefix is not None:
            have += self.prefix.evictable(protect=hit_pids)
        return have >= n_alloc - f_eff

    def _admit_legged(self, sess: EngineSession, req: Request,
                      rec: RequestRecord, now: float, drain: bool) -> float:
        """Admission via prefill legs: look up the shared prefix, allocate
        the continuation's pages (transformer) or restore the deepest
        resident snapshot (recurrent), split the rest of the prompt into
        legs, and run them (now, or interleaved — see `admit`)."""
        report = sess.report
        p, c = self.page_size, self._leg_c
        prompt = list(req.prompt)
        plen = len(prompt)
        if plen > self.prompt_pad:
            raise ValueError(f"prompt length {plen} exceeds "
                             f"prompt_pad {self.prompt_pad}")
        keys = page_keys(prompt, p) if self.prefix is not None else []
        f_eff, pids_hit, owned, pt_row, carry = 0, [], [], None, None
        if self._use_legs:
            if self.prefix is not None:
                got = self.prefix.lookup(keys)
                while f_eff < len(got) and got[f_eff] is not None:
                    f_eff += 1
                # the continuation must keep >= 1 real token: the legs
                # produce the first-token logits
                f_eff = min(f_eff, (plen - 1) // p)
                pids_hit = [got[j] for j in range(f_eff)]
                for pid in pids_hit:
                    self.pages.retain(pid)    # sharer refs FIRST: eviction
                                              # below must not free them
            _, n_alloc = self._pages_span(req)
            try:
                owned = self._alloc_pages(n_alloc - f_eff, req.rid,
                                          protect=pids_hit)
            except RuntimeError:
                for pid in pids_hit:
                    self.pages.release(pid)
                raise
            pt_row = self._row_tensor(
                pids_hit + owned + [SCRATCH] * (self._pt_width - n_alloc))
        else:
            # recurrent: ONE snapshot page restores the whole state at a
            # page boundary; take the deepest resident one, short of the
            # last token
            hit_j = -1
            if self.prefix is not None:
                got = self.prefix.lookup(keys)
                for j in range(min(len(got), (plen - 1) // p)):
                    if got[j] is not None:
                        hit_j = j
            if hit_j >= 0:
                carry = self._snap_get_fn(self._snap_pool(), got[hit_j])
                f_eff = hit_j + 1
            else:
                carry = self.model.init_cache(self.cfg, 1, self.max_seq,
                                              self.cache_dtype, self.device)
        start = f_eff * p
        legs, pos = [], start
        while pos < plen:
            span = min(c, plen - pos)
            toks = prompt[pos:pos + span] + [PAD_ID] * (c - span)
            legs.append((pos, span, self._row_tensor(toks)[None]))
            pos += span
        report.n_prefills += 1
        if start:
            report.prefix_hits += 1
            report.prefix_hit_vectors += start
        slot = sess.slots.alloc(req.rid)
        sess.slot_rec[slot] = rec
        if self._use_legs:
            sess.slot_pages[slot] = (owned, pids_hit)
        job = _PrefillJob(req=req, rec=rec, slot=slot, legs=legs,
                          pt_row=pt_row, keys=keys, f_eff=f_eff, carry=carry)
        if drain or not self._chunked:
            while not job.done:
                now = self._advance_leg(sess, job, now)
        else:
            sess.jobs.append(job)
        return now

    def _advance_leg(self, sess: EngineSession, job: _PrefillJob,
                     now: float) -> float:
        """Run ONE prefill leg; finalize the job after its last. Vector
        books advance per leg, so a cut job's record matches what the
        device observed."""
        report = sess.report
        pos0, span, toks = job.legs[job.leg_i]
        t0 = time.perf_counter()
        if self._use_legs:
            tok1, kp, vp = self._leg_fn(toks, sess.cache["kp"],
                                        sess.cache["vp"], job.pt_row, pos0,
                                        span)
            sess.cache["kp"], sess.cache["vp"] = kp, vp
        else:
            tok1, job.carry = self._leg_rec_fn(job.carry, toks, span)
        _wait(tok1)
        dt = time.perf_counter() - t0
        now += dt
        report.wall_prefill_s += dt
        report.observed_vectors += span
        report.prefill_chunks += 1
        rec = job.rec
        rec.prefill_vectors += span
        rec.pad_vectors += self._leg_c - span
        report.prefill_pad_vectors += self._leg_c - span
        job.tok1 = tok1
        job.leg_i += 1
        end = pos0 + span
        if self._snap and end % self.page_size == 0:
            self._register_snapshot(job, end)
        if job.done:
            now = self._finalize_job(sess, job, now)
        return now

    def _register_snapshot(self, job: _PrefillJob, end: int):
        """Store the carried recurrent state at a page-aligned leg end.
        Best effort: an exhausted pool skips the snapshot, never the
        request (restores need no sharer reference: an entry is the
        snapshot's only holder)."""
        key = job.keys[end // self.page_size - 1]
        if key in self.prefix:
            return
        pids = self.pages.alloc(1, owner=("snap", job.req.rid))
        if pids is None and self.prefix.evict(1):
            pids = self.pages.alloc(1, owner=("snap", job.req.rid))
        if pids is None:
            return
        self._snap_put_fn(self._snap_pool(), job.carry, pids[0])
        self.prefix.put(key, pids[0], adopt=True)

    def _finalize_job(self, sess: EngineSession, job: _PrefillJob,
                      now: float) -> float:
        """Last leg done: register the produced prefix pages, deliver or
        inspect the first token, and arm the decode lane."""
        report = sess.report
        req, rec, tok1 = job.req, job.rec, job.tok1
        plen = len(req.prompt)
        if self._use_legs and self.prefix is not None:
            # the cache takes one ref ON TOP of the producer's (released at
            # retire), so the pages outlive the request; first producer
            # wins, a racing duplicate's page stays request-owned
            owned, shared = sess.slot_pages[job.slot]
            pids_all = list(shared) + list(owned)
            for j in range(job.f_eff, plen // self.page_size):
                self.prefix.put(job.keys[j], pids_all[j])
        rec.t_first = now
        if self.eos_id is None:
            sess.lazy.append((rec, tok1))
        else:
            first = int(tok1[0, 0])
            if first == self.eos_id:
                self._retire(rec, "eos", now)
                self._free_slot(sess, job.slot)
                return now
            rec.tokens.append(first)
        t0 = time.perf_counter()
        if self._use_legs:
            self._register(sess, tok1, job.slot, plen, req.max_new,
                           job.pt_row)
        else:
            self._insert(sess, job.carry, tok1, job.slot, plen, req.max_new)
        dt = time.perf_counter() - t0
        now += dt
        report.wall_prefill_s += dt
        sess.rem[job.slot] = self._decode_budget(req)
        return now

    def _advance_prefill(self, sess: EngineSession, now: float) -> float:
        """Advance ONE leg of the oldest queued prefill job."""
        job = sess.jobs[0]
        now = self._advance_leg(sess, job, now)
        if job.done:
            sess.jobs.pop(0)
        return now

    def _release_slot_pages(self, sess: EngineSession, slot: int):
        """Drop the retiring slot's page refs (owned allocations and the
        sharer refs its prefix hits took); cache-registered pages survive
        through the cache's own reference."""
        held = sess.slot_pages.pop(slot, None)
        if held is None:
            return
        owned, shared = held
        for pid in list(owned) + list(shared):
            self.pages.release(pid)

    def _pick_chunk(self, sess: EngineSession, responsive: bool = False) -> int:
        """Chunk length for the next dispatch: the largest ladder length not
        past the longest projected remaining budget, or (``responsive``:
        requests wait for a slot) the smallest one covering the earliest
        projected retirement. 0 = every lane is projected retired."""
        rems = [r for r in (sess.rem.get(s, 0) for s in sess.slot_rec)
                if r > 0]
        if not rems:
            return 0
        if responsive:
            target = min(rems)
            for n in self._ladder:
                if n >= target:
                    return n
            return self._ladder[-1]
        target = max(rems)
        for n in reversed(self._ladder):
            if n <= target:
                return n
        return 1

    def _dispatch_chunk(self, sess: EngineSession, n: int) -> _PendingChunk:
        """Launch one ``n``-step chunk without waiting for it; the
        session's buffers advance to the chunk's outputs."""
        t0 = time.perf_counter()
        sess.tok_buf, sess.cache, sess.state, ys = self._safe_decodes[n](
            sess.cache, sess.tok_buf, sess.state, n)
        for slot in sess.slot_rec:
            sess.rem[slot] = max(0, sess.rem.get(slot, 0) - n)
        self._chunks_dispatched += 1
        return _PendingChunk(ys=ys, t_wall=t0,
                             prefill0=sess.report.wall_prefill_s, n=n,
                             health0=sess.report.wall_health_s,
                             recals0=sess.report.n_recals,
                             swap0=sess.report.wall_swap_s,
                             swaps0=sess.report.n_swaps)

    def step(self, sess: EngineSession, now: float) -> float:
        """One SYNCHRONOUS decode chunk (dispatched and processed at once)
        plus retirement bookkeeping, after the chunk-boundary resilience
        tick; returns the advanced clock. The caller guarantees a busy
        slot. With `admit(..., drain=True)` this drives a session by hand:
        each admission completes before the next."""
        now = self._resilience_tick(sess, now)
        now = self._placement_tick(sess, now)
        n = self._pick_chunk(sess) or 1
        return self._process_chunk(sess, self._dispatch_chunk(sess, n), now)

    def cancel_active(self, sess: EngineSession, now: float):
        """Retire every in-flight request with reason "cap" (a step
        budget ran out). The device rows stay stale: a cancelled session
        is never stepped again."""
        self._resolve_firsts(sess)
        for job in sess.jobs:
            self._retire(job.rec, "cap", now)
            self._free_slot(sess, job.slot)
        sess.jobs.clear()
        for slot in list(sess.slot_rec):
            self._retire(sess.slot_rec[slot], "cap", now)
            self._free_slot(sess, slot)

    def _process_chunk(self, sess: EngineSession, pend: _PendingChunk,
                       now: float) -> float:
        """Read one chunk's block back (the one host sync per chunk) and
        mirror its retirement rows into the host books. The chunk is billed
        its wall since dispatch minus prefill wall billed inside that
        window (admission overlaps the chunk in flight)."""
        report = sess.report
        ys = pend.ys.cpu()
        toks, acts, reasons = ys[:, 0], ys[:, 1], ys[:, 2]
        self._resolve_firsts(sess)
        overlap = ((report.wall_prefill_s - pend.prefill0)
                   + (report.wall_health_s - pend.health0)
                   + (report.wall_swap_s - pend.swap0))
        dt = max(time.perf_counter() - pend.t_wall - overlap, 0.0)
        now += dt
        report.wall_decode_s += dt
        ran = int(toks.shape[0])
        busy = int(acts.sum())
        report.n_steps += ran
        report.observed_vectors += busy
        report.idle_vectors += self.n_slots * ran - busy
        self._step_no += ran
        # a chunk whose window held a hot reprogram or a rotation swap is
        # slow by the engine's own doing: it is exempt from the straggler
        # EWMA
        self.monitor.record(self._step_no, dt / max(ran, 1),
                            exempt=(report.n_recals > pend.recals0
                                    or report.n_swaps > pend.swaps0))
        if self.heartbeat is not None:
            self.heartbeat.beat(
                self._step_no, slots_busy=sess.slots.n_busy,
                slots_free=sess.slots.n_free, chunk_len=ran,
                last_chunk_s=time.time(), wall_decode_s=report.wall_decode_s,
                n_recals=report.n_recals)
        for s in range(ran):
            for slot in list(sess.slot_rec):
                if not acts[s, slot]:
                    continue    # freed/refilled after this chunk's dispatch
                rec = sess.slot_rec[slot]
                rec.decode_vectors += 1
                r = int(reasons[s, slot])
                if r != 2:      # EOS is control, not payload
                    rec.tokens.append(int(toks[s, slot]))
                if r:
                    self._retire(rec, _REASONS[r], now)
                    self._free_slot(sess, slot)
        return now

    # -- drift / health / chaos (DESIGN.md §14) ----------------------------
    def _resilience_tick(self, sess: EngineSession, now: float) -> float:
        """Chunk-boundary resilience work: fire due chaos events, advance
        drift, probe the live states, hot-reprogram failing cores. A chunk
        already in flight was launched against the previous tree and is
        untouched; the wall spent here goes to ``wall_health_s`` (and out of
        the overlapping chunk's decode bill). Every update keeps the
        tree's shapes (drift scales s_w; a repaired state is shaped like
        the one it replaces)."""
        if self.health is None:
            return now
        t0 = time.perf_counter()
        report = sess.report
        forced = False
        if self.chaos is not None:
            for ev in self.chaos.due(self._chunks_dispatched):
                prog = self.health.program
                mag = 1.0 if ev.kind == chaos_lib.KILL else ev.magnitude
                entries = chaos_lib.corrupt_entries(prog, ev.core, mag)
                if ev.kind == chaos_lib.KILL:
                    self.health.mark_dead(ev.core)
                if entries:
                    self._set_params(prog.install_updates(self.params,
                                                          entries))
                report.fault_events.append(ev)
                forced = True
        if forced or self.health.due(now):
            drifted = self.health.drifted_entries(now)
            if drifted:
                self._set_params(self.health.program.install_updates(
                    self.params, drifted))
            sample = self.health.probe(installed_entries(self.params), now)
            report.probes += 1
            failing = self.health.failing_cores(sample)
            if failing:
                dead = set(failing) & self.health.dead
                t_r = time.perf_counter()
                entries, names, cm = self.health.recalibrate(failing, now)
                if names:
                    prog = self.health.program
                    self.program = prog
                    if (self.schedule is not None
                            and self.schedule.name == "from_program"):
                        self.schedule = CoreSchedule.from_program(
                            prog, pipelined=self.schedule.pipelined)
                    self._set_params(prog.install_updates(self.params,
                                                          entries))
                    _wait(next(iter(entries.values())).w_q)
                    ev = RecalEvent(
                        t=now,
                        reason=("dead_core" if dead
                                else "fault" if forced else "drift"),
                        cores=tuple(failing), names=names,
                        initialize=cm.initialize,
                        wall_s=time.perf_counter() - t_r)
                    self.health.events.append(ev)
                    report.recal_events.append(ev)
                    report.recal_initialize += cm.initialize
                    report.n_recals += 1
        wall = time.perf_counter() - t0
        report.wall_health_s += wall
        return now + wall

    # -- capacity-overflow rotation (core.placement, DESIGN.md §16) --------
    def _placement_tick(self, sess: EngineSession, now: float) -> float:
        """Chunk-boundary rotation swap: when the cadence is due, advance
        ONE rotation state, serve its tree, and bill the incoming group's
        reprogram as CM_INITIALIZE plus the host wall spent swapping. A
        chunk in flight was launched on the previous state's tree, so no
        token comes from a half-swapped program."""
        rot = self.rotation
        if rot is None or rot.n_states < 2:
            return now
        due = self._chunks_dispatched // rot.swap_every
        if due <= self._swaps_done:
            return now
        t0 = time.perf_counter()
        report = sess.report
        self._swaps_done = due
        state = (self._rot_state + 1) % rot.n_states
        self._use_tree(state, self._rotation_params[state])
        incoming = rot.incoming(state)
        cm = self.program.reprogram_counts(incoming)
        wall = time.perf_counter() - t0
        ev = SwapEvent(t=now, chunk=self._chunks_dispatched, state=state,
                       incoming=incoming, initialize=cm.initialize,
                       wall_s=wall)
        report.swap_events.append(ev)
        report.swap_initialize += cm.initialize
        report.n_swaps += 1
        report.wall_swap_s += wall
        return now + wall

    @property
    def rotation_state(self) -> int:
        """The rotation state whose tree the next dispatch runs on."""
        return self._rot_state

    def _free_slot(self, sess: EngineSession, slot: int):
        sess.slot_rec.pop(slot, None)
        sess.slots.release(slot)
        sess.rem.pop(slot, None)
        self._release_slot_pages(sess, slot)

    @staticmethod
    def _resolve_firsts(sess: EngineSession):
        """Read the deferred prefill first tokens; a record admitted after a
        chunk's dispatch is inactive for that whole chunk, so its first
        token always lands at index 0."""
        for rec, tok1 in sess.lazy:
            rec.tokens.insert(0, int(tok1[0, 0]))
        sess.lazy.clear()

    def finish(self, sess: EngineSession, now: float) -> ServeReport:
        """Close the session and return its report. A paged engine takes
        its pools back (prefix pages stay resident for the next session)
        and snapshots the allocator's exact-partition ledger."""
        self._resolve_firsts(sess)
        report = sess.report
        for job in sess.jobs:     # a closed session holds nothing
            self._retire(job.rec, "cap", now)
            self._free_slot(sess, job.slot)
        sess.jobs.clear()
        if self._paged_kv:
            self._pool = (sess.cache["kp"], sess.cache["vp"])
        if self.pages is not None:
            report.page_ledger = self.pages.ledger()
            report.page_ledger_exact = self.pages.verify()
        if self.prefix is not None:
            report.page_evictions = self.prefix.evictions - sess.evictions0
        report.makespan_s = now
        report.retries = self._retries - sess.retries0
        report.stragglers = list(self.monitor.flagged[sess.flagged0:])
        return report

    # -- the serving loop ----------------------------------------------------
    def serve(self, requests) -> ServeReport:
        """Serve a trace to completion on the engine clock (starts at 0,
        advances by measured wall time, jumps to the next arrival when every
        slot is empty). Decode is double-buffered: chunk i+1 is launched
        before chunk i's block is read back; chunked-prefill legs run one
        per loop iteration between chunks."""
        queue = Batcher(requests, policy=self.admission)
        sess = self.begin()
        now = 0.0
        pending: _PendingChunk | None = None
        while len(queue) or sess.slots.n_busy or pending is not None:
            while sess.slots.n_free:
                if self._paged_kv:
                    # ask the allocator BEFORE popping: a request that does
                    # not fit waits at the head (an empty engine can always
                    # cover one max-length request, ctor-checked)
                    req = queue.peek_ready(now)
                    if req is None or not self.can_admit(sess, req):
                        break
                    queue.pop_ready(now)
                else:
                    req = queue.pop_ready(now)
                    if req is None:
                        break
                now = self.admit(sess, req, now, drain=not self._chunked)
            if sess.jobs:
                now = self._advance_prefill(sess, now)
            now = self._resilience_tick(sess, now)
            now = self._placement_tick(sess, now)
            if not sess.slots.n_busy and pending is None:
                nxt = queue.next_arrival()
                if nxt is None:
                    break
                now = max(now, nxt)
                continue
            n_next = (self._pick_chunk(sess, responsive=bool(len(queue)))
                      if sess.slots.n_busy else 0)
            cur = self._dispatch_chunk(sess, n_next) if n_next else None
            if pending is not None:
                now = self._process_chunk(sess, pending, now)
            pending = cur
        return self.finish(sess, now)

    # -- CM_* books ----------------------------------------------------------
    def ledgers(self, report: ServeReport) -> dict:
        """rid -> CM_* counts (requires a programmed engine)."""
        from repro_torch.runtime.batcher import request_ledgers
        if self.program is None:
            raise ValueError("CM_* ledgers require an AimcProgram")
        if self.rotation is not None:
            raise ValueError(
                "per-request CM_* ledgers are ill-defined under rotation: "
                "a request's vectors span states with different analog "
                "sets; use report.swap_events + placement.reconcile_swaps")
        return request_ledgers(self.program, report.records)

    def core_ledgers(self, report: ServeReport) -> dict:
        """core -> CM_* totals for this run's useful vectors (requires a
        `CoreSchedule`): the per-core split of `ledgers`. Summed over cores
        the dequeue/initialize books close exactly against
        ``program.mvm_counts()`` (`batcher.reconcile_cores`)."""
        from repro_torch.runtime.batcher import aggregate_core_ledgers
        if self.schedule is None:
            raise ValueError("per-core ledgers require a CoreSchedule")
        return aggregate_core_ledgers(self.schedule, report.records)


class ShardedServeEngine(ServeEngine):
    """`ServeEngine` laid out on a `launch.mesh.Mesh` (the reference's
    `ShardedServeEngine`, `repro/runtime/engine.py:1792`).

    The reference compiles its closures once with `NamedSharding`-pinned
    inputs and outputs over a JAX mesh; the port is single-controller over
    a grid of positions, each naming a torch device:
      * parameters (`shardings.serve_engine_param_specs`): a programmed
        state becomes one column piece per ``model`` position
        (`shardings.place_params`; a state stays whole where its Np does
        not divide ``128 * M``), every digital leaf replicates (positions
        on one device share the tensor);
      * decode slots (`slot_cache_specs` at the batch axes, the token
        buffer, `slot_state_specs`): each lane's cache rows, token row and
        retirement rows live on its ``data`` position between chunks; a
        paged cache splits its pools at the page axis and its table and
        lengths at the slot axis. `fit_spec` keeps a leaf whole where it
        does not divide.
    A decode chunk gathers the lanes once at its start, runs the inherited
    decode (one forward per step over every lane, so the dynamic DAC scale
    and MoE capacity routing stay batch-global) and scatters the lanes
    back. Prefill runs ``[1, prompt_pad]`` as the single-device engine
    does and inserts into the lane's data position; a paged insert or a
    prefill leg moves only the request's pages. Its tokens equal the
    single-device engine's bit for bit: no reduction dimension is split.
    ``compile_counts`` counts each closure once, whatever the number of
    positions. Rotation is refused, as in the reference."""

    def __init__(self, model, cfg, exe: Execution, params, *, mesh,
                 model_axis: str = "model", **kw):
        # the launch layer is imported here, as the reference does, so the
        # single-device engine does not depend on it
        from repro_torch.launch import shardings
        from repro_torch.launch.mesh import Mesh
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a launch.mesh.Mesh, got "
                            f"{type(mesh).__name__}")
        if kw.get("rotation") is not None:
            raise ValueError(
                "ShardedServeEngine does not serve rotation plans: state "
                "swaps would re-place every parameter tree on the mesh "
                "mid-trace (use the single-device engine for overflow)")
        self.mesh = mesh
        self.model_axis = model_axis
        self._sh = shardings
        super().__init__(model, cfg, exe, params, **kw)
        self._set_params(self.params)

    def _set_params(self, params):
        # a state an update replaced arrives whole: split it again
        self.params = self._sh.place_params(params, self.mesh,
                                            self.model_axis)

    # -- placement of the slot state ----------------------------------------
    def _place_slots(self, tree, axes):
        sh = self._sh
        specs = sh.slot_cache_specs(tree, axes, self.mesh)
        return sh.place_tree(tree, specs, self.mesh)

    def _empty_cache(self):
        if self._paged_kv:
            return ServeEngine._empty_cache(self)   # -> _paged_cache_dict
        cache = ServeEngine._empty_cache(self)
        return self._place_slots(cache, {n: _batch_dim(n) for n in cache})

    def _fresh_pools(self):
        kp, vp = ServeEngine._fresh_pools(self)
        pools = self._place_slots({"kp": kp, "vp": vp}, {"kp": 1, "vp": 1})
        return pools["kp"], pools["vp"]

    def _paged_cache_dict(self, kp, vp):
        cache = ServeEngine._paged_cache_dict(self, kp, vp)
        rows = self._place_slots({"pt": cache["pt"], "len": cache["len"]},
                                 {"pt": 0, "len": 0})
        return {"kp": kp, "vp": vp, **rows}

    def _empty_tok_buf(self):
        from repro_torch.launch.mesh import dp_axes
        sh = self._sh
        tok = ServeEngine._empty_tok_buf(self)
        spec = sh.fit_spec(sh.P(dp_axes(self.mesh), None), tuple(tok.shape),
                           self.mesh)
        return sh.place(tok, spec, self.mesh)

    def _empty_state(self):
        sh = self._sh
        st = ServeEngine._empty_state(self)
        return sh.place_tree(st, sh.slot_state_specs(st, self.mesh),
                             self.mesh)

    # -- writes into one lane's data position --------------------------------
    def _arm(self, sess: EngineSession, tok1, slot: int, pos0: int,
             max_new: int):
        sess.tok_buf.write_(0, slot, tok1[0])
        st = sess.state
        st["active"].write_(0, slot, True)
        st["gen"].write_(0, slot, 1)
        st["pos"].write_(0, slot, pos0)
        st["max_new"].write_(0, slot, max_new)

    def _insert(self, sess: EngineSession, cache1, tok1, slot: int,
                pos0: int, max_new: int):
        self._note("insert", sess.cache, cache1, tok1)
        for name, leaf in sess.cache.items():
            dim = _batch_dim(name)
            leaf.write_(dim, slot, cache1[name].select(dim, 0))
        self._arm(sess, tok1, slot, pos0, max_new)

    def _point(self, sess: EngineSession, tok1, slot: int, pos0: int,
               max_new: int, pt_row):
        sess.cache["pt"].write_(0, slot, pt_row)
        sess.cache["len"].write_(0, slot, pos0)
        self._arm(sess, tok1, slot, pos0, max_new)

    def _register(self, sess: EngineSession, tok1, slot: int, pos0: int,
                  max_new: int, pt_row):
        self._note("register", sess.cache["pt"], sess.cache["len"], tok1,
                   pt_row)
        self._point(sess, tok1, slot, pos0, max_new, pt_row)

    def _insert_paged(self, sess: EngineSession, cache1, tok1, slot: int,
                      pos0: int, max_new: int, pt_row, write_mask):
        # only this request's pages move, each into the data block that
        # holds it (the page books are on the host: one read of the [M]
        # row). Pages the mask drops are never read; the single-device
        # engine parks them on the scratch page.
        self._note("insert_paged", sess.cache, cache1, tok1, pt_row,
                   write_mask)
        row = pt_row.tolist()
        keep = [j for j, k in enumerate(write_mask.tolist()) if k]
        for pool, src in (("kp", "k"), ("vp", "v")):
            placed = sess.cache[pool]
            pages = self._to_pages(cache1[src], placed.dtype)
            placed.put_rows_(1, [row[j] for j in keep], pages[:, keep])
        self._point(sess, tok1, slot, pos0, max_new, pt_row)

    def _leg_fn(self, tokens, kp, vp, pt_row, pos0: int, span: int):
        # a leg reads and writes this request's pages only: copy them into
        # a local pool behind a scratch page of its own, run the leg there
        # and put back the pages it touched
        row = pt_row.tolist()
        local = torch.arange(1, len(row) + 1, dtype=pt_row.dtype,
                             device=self.device)

        def pool(placed):
            pages = placed.rows(1, row, self.device)
            return torch.cat([torch.zeros_like(pages[:, :1]), pages], dim=1)
        tok, k_loc, v_loc = ServeEngine._leg_fn(self, tokens, pool(kp),
                                                pool(vp), local, pos0, span)
        p = self.page_size
        touched = list(range(pos0 // p, (pos0 + span - 1) // p + 1))
        at = [j + 1 for j in touched]
        kp.put_rows_(1, [row[j] for j in touched], k_loc[:, at])
        vp.put_rows_(1, [row[j] for j in touched], v_loc[:, at])
        return tok, kp, vp

    # -- decode: gather the lanes once per chunk -----------------------------
    def _on_lanes(self, decode, cache, tok_buf, state, length: int):
        sh, dev = self._sh, self.device
        tok, new_cache, new_state, ys = decode(
            sh.gather_tree(cache, dev), tok_buf.gather(dev),
            sh.gather_tree(state, dev), length)
        tok_buf.scatter_(tok)
        sh.scatter_tree_(cache, new_cache)
        sh.scatter_tree_(state, new_state)
        return tok_buf, cache, state, ys

    def _decode_fn(self, cache, tok_buf, state, length: int):
        return self._on_lanes(super()._decode_fn, cache, tok_buf, state,
                              length)

    def _decode_paged_fn(self, cache, tok_buf, state, length: int):
        return self._on_lanes(super()._decode_paged_fn, cache, tok_buf,
                              state, length)

    # -- books ---------------------------------------------------------------
    def device_ledgers(self, report: ServeReport) -> dict:
        """model-axis device slot -> CM_* totals for this run, through the
        schedule's core -> slot placement (`CoreSchedule.mesh_placement`)."""
        if self.schedule is None:
            raise ValueError("device ledgers require a CoreSchedule")
        n_vec = report.useful_vectors
        return {dev: led.cm.scaled(n_vec)
                for dev, led in self.schedule.device_ledgers(
                    self.mesh, self.model_axis).items()}


# ---------------------------------------------------------------------------
# the static-batch path (A/B baseline + bit-equality oracle)
# ---------------------------------------------------------------------------

def _static_closures(model, cfg, exe: Execution, max_seq: int, cache_dtype):
    """The static path's (prefill, decode): ``prefill(params, prompts,
    frames=None, valid_len=None)`` (``frames`` feed an enc-dec encoder,
    ``valid_len`` serves right-padded prompts) -> (logits, cache),
    ``decode(params, cache, tokens)`` -> (logits, cache); both without
    autograd."""
    @torch.no_grad()
    def prefill(params, prompts, frames=None, valid_len=None):
        kw = {} if valid_len is None else {"valid_len": valid_len}
        if frames is not None:
            return model.prefill(params, frames, prompts, cfg, exe,
                                 max_seq=max_seq, cache_dtype=cache_dtype,
                                 **kw)
        return model.prefill(params, prompts, cfg, exe, max_seq=max_seq,
                             cache_dtype=cache_dtype, **kw)

    @torch.no_grad()
    def decode(params, cache, tokens):
        return model.decode_step(params, cache, tokens, cfg, exe)
    return prefill, decode


def static_generate(model, cfg, exe: Execution, params, prompts, gen: int,
                    max_seq: int | None = None, cache_dtype=torch.float32,
                    frames=None, valid_len=None):
    """The monolithic serve loop the engine replaced: one synchronized
    batch, one prompt length, ``gen`` lockstep decode steps.

    prompts: [B, P] int32 on the device of ``params``; ``frames`` [B, S, d]
    are an enc-dec model's encoder input (the prompts are then its decoder
    tokens); ``valid_len`` ([1] int32, a port-only option) serves one
    right-padded prompt (B = 1) from its last valid position, at the
    engine's [1, prompt_pad] prefill shape. Returns
    ([B, gen] tokens, wall seconds (prefill_s, decode_s)). ``gen=1`` is
    prefill-only: no decode loop runs and the decode time is 0.0."""
    b, p = prompts.shape
    if valid_len is not None and b != 1:
        raise ValueError(f"valid_len serves one padded prompt, got {b}")
    max_seq = max_seq or (p + gen)
    prefill, decode = _static_closures(model, cfg, exe, max_seq, cache_dtype)
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompts, frames, valid_len)
    out = [logits[:, -1].argmax(-1).to(torch.int32)[:, None]]
    _wait(out[-1])
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = decode(params, cache, out[-1])
        out.append(logits[:, -1].argmax(-1).to(torch.int32)[:, None])
    if gen > 1:
        _wait(out[-1])
    t_decode = time.perf_counter() - t0 if gen > 1 else 0.0
    return torch.cat(out, dim=1), (t_prefill, t_decode)
