"""ServeEngine: request-level continuous batching over a programmed AIMC
model (PyTorch port of the dense mode of `repro/runtime/engine.py`).

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

The reference compiles three closures once and asserts it
(`compile_counts`); PyTorch runs eagerly, so there is no counterpart here.

CM_* accounting: every useful token vector (prompt tokens at prefill, one
vector per decode step a request rides in) is booked to its request;
`batcher.reconcile` proves the per-request ledgers sum exactly to
``program.mvm_counts().scaled(observed_vectors)``.

Paged KV, prefix cache, chunked prefill, drift/chaos resilience, rotation
and the sharded engine are later slices.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.models.layers import Execution, mask_batch_select
from repro_torch.runtime.batcher import (Batcher, Request, RequestRecord,
                                         SlotAllocator, percentile)
from repro_torch.runtime.fault_tolerance import (StragglerMonitor,
                                                 resilient_step)


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


# retirement codes emitted by the decode loop (0 = still running)
_REASONS = {1: "length", 2: "eos", 3: "cap"}
_CACHE_BATCH_DIM = {"k": 1, "v": 1, "len": 0}
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


class ServeEngine:
    """Continuous-batching serving engine over one (installed) model.

    ``params`` carries installed `AimcLinearState`s for the programmed AIMC
    path (``program.install(params)``); pass the `AimcProgram` as
    ``program`` for CM_* ledger reconciliation. Everything runs on the
    device of ``params["embed"]``; ``eos_id`` retires a lane when it emits
    that token (the token is control, not payload)."""

    def __init__(self, model, cfg, exe: Execution, params, *,
                 n_slots: int = 4, prompt_pad: int = 16, max_seq: int = 64,
                 program=None, eos_id: int | None = None,
                 decode_chunk: int = 1):
        if prompt_pad > max_seq:
            raise ValueError(f"prompt_pad {prompt_pad} > max_seq {max_seq}")
        if decode_chunk < 1:
            raise ValueError(f"decode_chunk must be >= 1, got {decode_chunk}")
        self.model, self.cfg, self.exe, self.params = model, cfg, exe, params
        self.device = params["embed"].device
        self.n_slots, self.prompt_pad, self.max_seq = n_slots, prompt_pad, max_seq
        self.program = program
        self.eos_id = eos_id
        self.decode_chunk = decode_chunk
        self._ladder = self.chunk_ladder(decode_chunk)
        self.monitor = StragglerMonitor(threshold=STRAGGLER_THRESHOLD)
        self._retries = 0
        self._step_no = 0
        # model forward passes run by this engine, warmup included (each
        # prefill and each decode step is one pass over every layer)
        self.forward_passes = 0
        self._safe_decodes = {
            n: resilient_step(self._decode_fn, max_retries=MAX_RETRIES,
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

    # -- device functions ----------------------------------------------------
    def _prefill_fn(self, tokens, valid_len):
        """[1, prompt_pad] ragged prefill -> (first_tok [1,1], cache1)."""
        logits, cache = self.model.prefill(
            self.params, tokens, self.cfg, self.exe, max_seq=self.max_seq,
            cache_dtype=CACHE_DTYPE, valid_len=valid_len)
        self.forward_passes += 1
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        return tok, cache

    def _insert(self, sess: EngineSession, cache1, tok1, slot: int,
                pos0: int, max_new: int):
        """Write a prefilled request into decode lane ``slot``, including
        its on-device retirement row (gen starts at 1: the prefill's token
        counts against max_new). In place on the session's tensors, which
        are stream-ordered after any chunk already launched on them."""
        for name, dim in _CACHE_BATCH_DIM.items():
            sess.cache[name].select(dim, slot).copy_(
                cache1[name].select(dim, 0))
        sess.tok_buf[slot] = tok1[0]
        st = sess.state
        st["active"][slot] = True
        st["gen"][slot] = 1
        st["pos"][slot] = pos0
        st["max_new"][slot] = max_new

    def _decode_fn(self, cache, tok_buf, state, length: int):
        """``length`` dense decode steps; inactive lanes are bit-frozen and
        the retirement predicates run on the device. Returns (tok_buf,
        cache, state, ys) with ys int32 [length, 3, S] = (emitted token,
        active at entry, reason) per step. Inputs are not modified."""
        rows = []
        tokens = tok_buf
        for _ in range(length):
            active = state["active"]
            logits, new_cache = self.model.decode_step(
                self.params, cache, tokens, self.cfg, self.exe, ragged=True)
            self.forward_passes += 1
            cache = {name: mask_batch_select(new_cache[name], cache[name],
                                             active, dim)
                     for name, dim in _CACHE_BATCH_DIM.items()}
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            tokens = torch.where(active[:, None], tok, tokens)
            emitted = tokens[:, 0]
            step = active.to(torch.int32)
            gen = state["gen"] + step
            pos = state["pos"] + step
            reason = torch.zeros_like(emitted)
            reason = torch.where(pos >= self.max_seq, 3, reason)
            reason = torch.where(gen >= state["max_new"], 1, reason)
            if self.eos_id is not None:
                reason = torch.where(emitted == self.eos_id, 2, reason)
            reason = torch.where(active, reason, 0)
            rows.append(torch.stack([emitted, step, reason]))
            state = {"active": active & (reason == 0), "gen": gen,
                     "pos": pos, "max_new": state["max_new"]}
        return tokens, cache, state, torch.stack(rows)

    # -- buffers -------------------------------------------------------------
    def _empty_cache(self):
        return self.model.init_cache(self.cfg, self.n_slots, self.max_seq,
                                     CACHE_DTYPE, self.device)

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

    def warmup(self):
        """Run every device path once (prefill, insert, one chunk of each
        ladder length) outside the serving clock: kernels build and load,
        allocator pools fill."""
        tokens = torch.zeros((1, self.prompt_pad), dtype=torch.int32,
                             device=self.device)
        vl = torch.ones((1,), dtype=torch.int32, device=self.device)
        tok1, cache1 = self._prefill_fn(tokens, vl)
        sess = self.begin()
        self._insert(sess, cache1, tok1, 0, 1, 1)
        tok_buf, cache, state = sess.tok_buf, sess.cache, sess.state
        for n in self._ladder:
            tok_buf, cache, state, ys = self._decode_fn(cache, tok_buf,
                                                        state, n)
        ys.cpu()

    def _count_retry(self):
        self._retries += 1

    # -- request plumbing ----------------------------------------------------
    def _pad_prompt(self, prompt):
        if len(prompt) > self.prompt_pad:
            raise ValueError(f"prompt length {len(prompt)} exceeds "
                             f"prompt_pad {self.prompt_pad}")
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
        """Open a serving session: fresh slots, device buffers and books."""
        return EngineSession(
            report=ServeReport(records={}), slots=SlotAllocator(self.n_slots),
            slot_rec={}, cache=self._empty_cache(),
            tok_buf=self._empty_tok_buf(), state=self._empty_state(),
            retries0=self._retries, flagged0=len(self.monitor.flagged))

    @staticmethod
    def _retire(rec: RequestRecord, reason: str, at: float):
        rec.finish_reason = reason
        rec.t_done = at

    def admit(self, sess: EngineSession, req: Request, now: float) -> float:
        """Admit one request at clock ``now``: prefill, book, and either
        retire at prefill (max_new=1 / instant EOS) or insert into a free
        slot. Returns the advanced clock; the caller guarantees a free
        slot."""
        report = sess.report
        rec = RequestRecord(request=req, t_admit=now)
        report.records[req.rid] = rec
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
        sess.rem[slot] = min(req.max_new - 1, self.max_seq - len(req.prompt))
        t0 = time.perf_counter()
        self._insert(sess, cache1, tok1, slot, len(req.prompt), req.max_new)
        ins = time.perf_counter() - t0
        now += ins
        report.wall_prefill_s += ins
        return now

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
        return _PendingChunk(ys=ys, t_wall=t0,
                             prefill0=sess.report.wall_prefill_s, n=n)

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
        overlap = report.wall_prefill_s - pend.prefill0
        dt = max(time.perf_counter() - pend.t_wall - overlap, 0.0)
        now += dt
        report.wall_decode_s += dt
        ran = int(toks.shape[0])
        busy = int(acts.sum())
        report.n_steps += ran
        report.observed_vectors += busy
        report.idle_vectors += self.n_slots * ran - busy
        self._step_no += ran
        self.monitor.record(self._step_no, dt / max(ran, 1))
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

    @staticmethod
    def _free_slot(sess: EngineSession, slot: int):
        sess.slot_rec.pop(slot, None)
        sess.slots.release(slot)
        sess.rem.pop(slot, None)

    @staticmethod
    def _resolve_firsts(sess: EngineSession):
        """Read the deferred prefill first tokens; a record admitted after a
        chunk's dispatch is inactive for that whole chunk, so its first
        token always lands at index 0."""
        for rec, tok1 in sess.lazy:
            rec.tokens.insert(0, int(tok1[0, 0]))
        sess.lazy.clear()

    def finish(self, sess: EngineSession, now: float) -> ServeReport:
        """Close the session and return its report."""
        self._resolve_firsts(sess)
        report = sess.report
        report.makespan_s = now
        report.retries = self._retries - sess.retries0
        report.stragglers = list(self.monitor.flagged[sess.flagged0:])
        return report

    # -- the serving loop ----------------------------------------------------
    def serve(self, requests) -> ServeReport:
        """Serve a trace to completion on the engine clock (starts at 0,
        advances by measured wall time, jumps to the next arrival when every
        slot is empty). Decode is double-buffered: chunk i+1 is launched
        before chunk i's block is read back."""
        queue = Batcher(requests)
        sess = self.begin()
        now = 0.0
        pending: _PendingChunk | None = None
        while len(queue) or sess.slots.n_busy or pending is not None:
            while sess.slots.n_free:
                req = queue.pop_ready(now)
                if req is None:
                    break
                now = self.admit(sess, req, now)
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
        return request_ledgers(self.program, report.records)
