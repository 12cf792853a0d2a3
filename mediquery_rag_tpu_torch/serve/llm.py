"""Continuous-batching LLM server (port of ``mediquery_rag_tpu/serve/llm.py``).

The engine behind ``/v1/chat/completions`` and ``/qa``'s LLM calls when the
app serves its own decoder: many requests share one decode loop, so a new
arrival never waits for someone else's whole generation.

- **Slot model.** The batch dimension is ``slots`` fixed serving lanes, each
  an independent request at its own cache column
  (``Decoder.decode_step_slots``). Admission prefills the prompt and copies
  its K/V into the lane.
- **Chunked scheduling.** The worker thread decodes up to ``chunk`` steps
  for all lanes (an eager loop; it exits early once no lane is live, one
  host sync per step) and schedules only between chunks: admit arrivals,
  land prefill pieces, harvest EOS/budget/cache-end completions, resolve
  futures.
- **Chunked prefill.** A long prompt arriving while others decode lands
  ``prefill_chunk`` tokens per scheduler iteration (``prefill_extend``), so
  co-tenant decode interleaves with it.
- **Sessions.** ``ChatSession`` pins a conversation to a lane whose cache
  persists between turns; the next turn prefills only the suffix past the
  shared token prefix.
- **In-place state.** The cache, cursors and carried logits live on the
  device and are updated in place.

Greedy output equals the lockstep ``Generator.generate`` output for the
same prompt, and does not depend on who shares the batch: every operation
of a step is row-wise (the matvecs quantize activations per row, the
attention splits depend on ``slots`` alone). Sampled tokens come from one
``torch.Generator`` seeded with ``seed``, so they depend on the
interleaving. A request with ``schema=`` decodes under that schema's
compiled DFA (models/constrain.py), lane by lane: the registered schemas'
tables are stacked on the device, each lane carries its schema index (-1 =
free text) and DFA state, and each step masks the constrained lanes'
logits (``generate.dfa_mask``).

Speculative serving (``draft=``): while every live lane is greedy, free
text and stops at EOS, a scheduling quantum is up to ``spec_rounds``
propose -> verify rounds instead of ``chunk`` decode steps. Per round the
draft proposes ``gamma`` tokens per lane (``gamma + 1`` one-token
``Decoder.extend_slots`` over its own cache, the last consuming the final
candidate), the target verifies every lane's ``gamma + 1`` candidates in one
batched ``extend_slots``, and each lane keeps the prefix its target agrees
with plus the target's own next token; both caches roll back by resetting
the lane's cursor and masking the columns at and after it dead. A lane that
samples, is constrained or ignores EOS sends the server back to plain
quanta, after which the draft lanes resync from the transcripts (a draft
prefill over the lane's last tokens, windowed to the draft cache). Greedy
output stays the target's own; the draft moves only the tokens per round.

Over a tensor-parallel generator (``Generator(mesh=)``, one process per
rank) every rank runs this scheduler, because it edits the caches itself
between decoder calls. Model rank 0 serves (``submit``, futures, its
worker thread); the others call ``follow()``. At the top of each iteration
rank 0 broadcasts one record (``collectives.broadcast_bytes``): the
requests it takes this iteration, the ids of cancelled ones, and stop.
Whatever reads the request queue, a future or the clock is decided on
rank 0 alone and carried in that record; the rest (lanes, pieces, quanta,
harvests) follows from it and the shared logits on every rank, and sampled
tokens are rank 0's (``Generator.share_pick``). A draft (``draft=``) is a
whole generator, replicated on every rank. A failed iteration stops a
tensor-parallel server (its ranks cannot rebuild in step); a rank that
dies ends the run through ``parallel.dist.launch``.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from mediquery_rag_tpu_torch.models.generate import (
    Generator, _round_up, constraint_tables, dfa_advance, dfa_mask)
from mediquery_rag_tpu_torch.obs import tracing
from mediquery_rag_tpu_torch.parallel import collectives as cc


class ServerSaturated(RuntimeError):
    """Raised by ``submit`` when the request backlog reaches
    ``max_backlog`` — the signal the HTTP layer maps to 429. Shedding at
    admission lets a caller retry elsewhere instead of timing out in an
    unbounded queue."""


@dataclass
class _Request:
    prompt: str
    max_new: int
    temperature: float
    future: Future
    session: str | None = None
    top_p: float = 1.0
    on_text: object = None       # streaming callback: fn(delta_text: str)
    ignore_eos: bool = False     # benchmark mode: decode past EOS to budget
    schema: dict | None = None   # models/constrain.py schema of the reply
    rid: int = 0                 # rank 0's request number, from the iteration that takes it
    cancelled: bool = False      # cancellation as rank 0's last record saw it
    tokens: list = field(default_factory=list)
    prompt_ids: list = field(default_factory=list)  # real prefilled tokens
    streamed: int = 0            # characters already flushed to on_text
    t_submit: float = 0.0
    t_first: float | None = None  # first token emitted (TTFT)
    t_submit_ns: int = 0         # ``time.time_ns()`` at submit (rank 0), for the queue span
    t_admit_ns: int = 0          # and at admission, for the prefill span


@dataclass
class _PendingPrefill:
    """A long admission prefilled in pieces: the lane stays inactive while
    its prompt lands ``prefill_chunk`` tokens per scheduler iteration."""

    req: _Request
    toks: list
    done: int = 0


@dataclass
class _Session:
    """Host bookkeeping for a lane-pinned chat session. ``tokens`` mirrors
    a prefix of the lane's cache (prompt + the tokens the user was given);
    token i lives at column ``first_col + i``. Anything the cache holds
    beyond it (an EOS, overshoot inside a chunk) is rolled back and masked
    dead by the next turn's extension."""

    lane: int
    first_col: int
    tokens: list
    last_use: float


class LLMServer:
    """Continuous-batching server over a ``Generator``'s model.

    >>> srv = LLMServer(generator, slots=4)
    >>> text = srv.submit("prompt", max_new_tokens=64).result()
    """

    def __init__(self, generator: Generator, *, slots: int = 4,
                 chunk: int = 32, cache_len: int | None = None, seed: int = 0,
                 draft: Generator | None = None, gamma: int = 4,
                 spec_rounds: int | None = None, prefill_chunk: int = 256,
                 max_backlog: int = 0):
        self.gen = generator
        cfg = generator.cfg
        self.model = generator.model
        self.tok = generator.tokenizer
        self.device = generator.device
        self.B = slots
        self.T = chunk
        self.C = cache_len or cfg.max_len
        if self.C > cfg.max_len:
            raise ValueError(f"cache_len {self.C} > model max_len {cfg.max_len}")
        self._rng = torch.Generator(device=self.device).manual_seed(seed)
        self._eos = int(self.tok.eos_id)
        self._pad = int(self.tok.pad_id)
        self.draft = draft
        self.gamma = gamma
        if draft is not None:
            self._size_rounds(cfg, spec_rounds)
        # a lane closer to the cache end than one round's writes finishes
        self._margin = gamma + 1 if draft is not None else 1
        self._draft_dirty = [True] * self.B
        # grammar constraints: registered schemas stack into one padded table
        self._schemas: dict[str, int] = {}      # canonical json -> index
        self._constraints: list = []            # JsonConstraint, by index
        self._tables = None                     # generate.constraint_tables()
        self._make_empty()

        self._slots: list[_Request | None] = [None] * self.B
        self._pending: dict[int, _PendingPrefill] = {}
        self.prefill_chunk = prefill_chunk
        self.max_backlog = max_backlog
        self._queue: queue.Queue = queue.Queue()
        self._held: deque = deque()     # taken from the queue, not yet admitted
        self._stop = threading.Event()
        self._sessions: dict[str, _Session] = {}
        self._lane_owner: list[str | None] = [None] * self.B
        self._clock = 0.0          # monotone LRU tick
        self.stats = {"requests": 0, "chunks": 0, "prefills": 0,
                      "tokens_out": 0, "extends": 0,
                      "prefix_tokens_reused": 0, "prefill_pieces": 0,
                      "steps": 0, "decode_s": 0.0, "spec_rounds": 0, "spec_lane_rounds": 0,
                      "spec_tokens": 0, "draft_syncs": 0, "spec_s": 0.0, "cancelled": 0,
                      "rejected": 0, "errors": 0}
        # bounded: a long-lived server must not grow per-request state
        self._lat_total: deque = deque(maxlen=8192)   # submit -> done, s
        self._lat_first: deque = deque(maxlen=8192)   # submit -> first token, s
        # tensor-parallel serving: the model group, and whether this rank leads
        self._group = self.model.tp
        self._lead = self._group is None or generator.mesh.model_rank == 0
        self._rids = 0
        # over a mesh, (request number, token ids) of the last 8,192 finished,
        # in finishing order, for the ranks to compare; a single card keeps none
        self.finished: deque | None = None if self._group is None else deque(maxlen=8192)
        self.error: Exception | None = None
        self._worker = threading.Thread(target=self._loop, daemon=True)
        if self._lead:
            self._worker.start()

    def _size_rounds(self, cfg, spec_rounds: int | None) -> None:
        """Check the draft and size the draft cache ``Cd`` and the rounds
        per quantum (JAX ``LLMServer.__init__``): by default ceil(chunk /
        2), so a quantum yields about a plain chunk's tokens at 2 accepted
        per round, lowered until a quantum's writes fit the draft cache."""
        gamma, draft = self.gamma, self.draft
        if draft.cfg.vocab_size != cfg.vocab_size:
            raise ValueError("draft/target vocab mismatch")
        if gamma < 1:
            raise ValueError("gamma must be >= 1")
        self.Cd = min(self.C, draft.cfg.max_len)
        self.Cd -= self.Cd % 128

        def fits(rounds: int) -> bool:
            return self.Cd >= _round_up(rounds * (gamma + 1) + 1, 128) + 128
        if spec_rounds is not None:
            self._rounds = max(1, spec_rounds)
            if not fits(self._rounds):
                raise ValueError(f"draft cache too small ({self.Cd}) for "
                                 f"{self._rounds} rounds of gamma={gamma}")
            return
        self._rounds = max(1, -(-self.T // 2))
        while self._rounds > 1 and not fits(self._rounds):
            self._rounds -= 1
        if not fits(self._rounds):
            raise ValueError(f"draft cache too small ({self.Cd}) for even one round "
                             f"of gamma={gamma}")

    def _make_empty(self) -> None:
        """Fresh device state: an empty per-lane cache and zero logits (and
        an empty draft cache)."""
        self.cache = self.model.empty_cache(self.B, self.C)
        dev = self.cache.k.device
        self.logits = torch.zeros((self.B, self.gen.cfg.vocab_size), device=dev)
        self.dfa = torch.zeros(self.B, dtype=torch.long, device=dev)
        self.schema = torch.full((self.B,), -1, dtype=torch.long, device=dev)
        self.dcache = (None if self.draft is None
                       else self.draft.model.empty_cache(self.B, self.Cd))

    # -- client API ----------------------------------------------------------

    def submit(self, prompt: str, *, max_new_tokens: int = 256,
               temperature: float = 0.0, top_p: float = 1.0,
               session: str | None = None, schema: dict | None = None,
               on_text=None, ignore_eos: bool = False) -> Future:
        """Queue a request; returns a future of the decoded text.
        ``session``: opaque id pinning the conversation to a lane whose
        cache persists between turns (see ``ChatSession``). ``on_text``:
        streaming callback ``fn(delta)`` called from the worker at every
        chunk boundary with the newly decoded text. ``.cancel()`` on the
        future drops the request (at the next chunk boundary if decoding).
        ``ignore_eos``: decode exactly ``max_new_tokens`` tokens.
        ``schema``: a models/constrain.py restricted JSON schema; the lane
        decodes under its compiled DFA, so the reply is valid JSON of that
        schema by construction, while other lanes decode free text. Raises
        ``ServerSaturated`` when ``max_backlog`` > 0 requests already wait."""
        if not self._lead:
            raise RuntimeError("a follower rank takes no requests: model rank 0 serves")
        if self._stop.is_set():
            raise RuntimeError("LLMServer is stopped (closed or device failure)")
        if self.max_backlog and self._queue.qsize() >= self.max_backlog:
            self.stats["rejected"] += 1
            raise ServerSaturated(
                f"backlog {self._queue.qsize()} >= max_backlog {self.max_backlog}")
        fut: Future = Future()
        self._queue.put(_Request(prompt, max_new_tokens, temperature, fut,
                                 session, top_p, on_text, ignore_eos=ignore_eos,
                                 schema=schema, t_submit=time.perf_counter(),
                                 t_submit_ns=time.time_ns()))
        return fut

    def complete(self, prompt: str, *, max_new_tokens: int = 256,
                 temperature: float = 0.0, top_p: float = 1.0,
                 timeout: float = 600.0, session: str | None = None,
                 schema: dict | None = None) -> str:
        return self.submit(prompt, max_new_tokens=max_new_tokens,
                           temperature=temperature, top_p=top_p, session=session,
                           schema=schema).result(timeout=timeout)

    def complete_batch(self, prompts: Sequence[str], **kw) -> list[str]:
        timeout = kw.pop("timeout", 600.0)
        futs = [self.submit(p, **kw) for p in prompts]
        return [f.result(timeout=timeout) for f in futs]

    def close(self) -> None:
        self._stop.set()
        if self._worker.is_alive():
            self._worker.join(timeout=30.0)
        # a caller blocked on .result() must see the shutdown, not a timeout
        err = RuntimeError("LLMServer closed")
        for b, req in enumerate(self._slots):
            if req is not None:
                _fail(req.future, err)
                self._slots[b] = None
        for slot, p in list(self._pending.items()):
            _fail(p.req.future, err)
            del self._pending[slot]
        while self._held:
            _fail(self._held.popleft().future, err)
        while True:
            try:
                _fail(self._queue.get_nowait().future, err)
            except queue.Empty:
                break

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- device programs -----------------------------------------------------

    def _register_schema(self, schema: dict) -> int:
        """Compile ``schema`` and add it to the stacked device tables
        (worker thread only)."""
        from mediquery_rag_tpu_torch.models.constrain import JsonConstraint

        key = json.dumps(schema, sort_keys=True)
        idx = self._schemas.get(key)
        if idx is not None:
            return idx
        c = JsonConstraint.compile(schema, self.tok, vocab_size=self.gen.cfg.vocab_size)
        self._constraints.append(c)
        idx = len(self._constraints) - 1
        self._schemas[key] = idx
        self._tables = constraint_tables(self._constraints, self.logits.device)
        return idx

    def _schema_idx(self, req: _Request) -> int:
        """The request's schema index (registered on first use), -1 for
        free text; raises its token budget to the grammar's longest path so
        constrained output never truncates mid-JSON."""
        if req.schema is None:
            return -1
        idx = self._register_schema(req.schema)
        req.max_new = max(req.max_new, self._constraints[idx].max_len_bytes)
        return idx

    def _pick(self, logits: torch.Tensor, temps: list[float],
              top_ps: list[float]) -> torch.Tensor:
        """Next token of every lane: greedy where the temperature is 0,
        else sampled after temperature and, where ``top_p`` < 1, the
        nucleus cut (HF order: temperature first; the top-1 token is always
        kept)."""
        greedy = torch.argmax(logits, dim=-1)
        if not any(t > 0.0 for t in temps):
            return self._share(greedy, True)
        dev = logits.device
        t = torch.clamp(torch.tensor(temps, device=dev), min=1e-6)
        p = torch.tensor(top_ps, device=dev)
        warped = logits / t[:, None]
        if any(tp < 1.0 and tt > 0.0 for tp, tt in zip(top_ps, temps)):
            srt = torch.sort(warped, dim=-1, descending=True).values
            probs = torch.softmax(srt, dim=-1)
            keep = (torch.cumsum(probs, dim=-1) - probs) < p[:, None]
            thr = torch.where(keep, srt, torch.full_like(srt, float("inf"))).amin(dim=-1)
            thr = torch.where(p >= 1.0, torch.full_like(thr, -float("inf")), thr)
            warped = torch.where(warped >= thr[:, None], warped,
                                 torch.full_like(warped, -1e9))
        sampled = torch.multinomial(torch.softmax(warped, dim=-1), 1,
                                    generator=self._rng)[:, 0]
        hot = torch.tensor(temps, device=dev) > 0.0
        return self._share(torch.where(hot, sampled, greedy), ~hot)

    def _share(self, tok: torch.Tensor, greedy) -> torch.Tensor:
        """Model rank 0's picks on every rank of a tensor-parallel server."""
        return tok if self._group is None else self.gen.share_pick(tok, greedy)

    def _decode_chunk(self, active: list[bool]) -> np.ndarray:
        """Up to ``chunk`` steps for all lanes; returns tokens [B, T] (pad
        after a lane's EOS). Stops early once no lane is live. Counts the
        steps and their host wall time (``stats["steps"]``, ``"decode_s"``),
        and records them as one ``llm.decode`` span timed on the device too:
        its stream time starts after whatever prefill was queued before it."""
        t0 = time.perf_counter()
        dev = self.logits.device
        with tracing.span("llm.decode", device=dev) as sp:
            temps = [r.temperature if r else 0.0 for r in self._slots]
            top_ps = [r.top_p if r else 1.0 for r in self._slots]
            keep_eos = torch.tensor([bool(r is not None and r.ignore_eos)
                                     for r in self._slots], device=dev)
            live = torch.tensor(active, device=dev)
            out = torch.full((self.B, self.T), self._pad, dtype=torch.long, device=dev)
            pad = torch.full_like(out[:, 0], self._pad)
            constrained = self._tables is not None and any(
                r is not None and r.schema is not None for r in self._slots)
            if constrained:
                base = (self.schema.clamp(min=0) * self._tables[-1])[:, None]
                free = (self.schema < 0)[:, None]
            for t in range(self.T):
                if not bool(live.any()):          # the one host sync of a step
                    break
                logits = self.logits
                if constrained:
                    logits, land = dfa_mask(self._tables, base, self.dfa, logits,
                                            self._eos, free)
                tok = torch.where(live, self._pick(logits, temps, top_ps), pad)
                out[:, t] = tok
                if constrained:
                    self.dfa = dfa_advance(land, tok, self.dfa,
                                           live & ~free[:, 0] & (tok != self._eos))
                self.logits = self.model.decode_step_slots(self.cache, tok, live)
                live = live & ((tok != self._eos) | keep_eos)
                self.stats["steps"] += 1
                sp.n += 1
            toks = out.cpu().numpy()
        self.stats["decode_s"] += time.perf_counter() - t0
        return toks

    def _spec_quantum(self, active: list[bool]) -> tuple[np.ndarray, np.ndarray]:
        """Up to ``_rounds`` propose -> verify rounds for every lane (JAX
        ``_spec_program``); returns the tokens [B, rounds * G], written
        compactly per lane, and each lane's count of emitted tokens (a lane
        that runs out of cache room stops emitting without an EOS, so the
        pad tail is not output). A lane stops once it has emitted its
        request's remaining budget (JAX runs it to the quantum's end and
        drops the surplus; the output is the same). Acceptance, cursors and
        the rollback stay on the device; each round reads the host once,
        for whether any lane is still live. Counts rounds, lane rounds (the
        live lanes summed over rounds: tokens per lane round is the
        acceptance), emitted tokens and host seconds, and records the
        quantum as one ``llm.spec`` span timed on the device, ``n`` its
        rounds."""
        t0 = time.perf_counter()
        dev = self.logits.device
        with tracing.span("llm.spec", device=dev) as sp:
            cache, dcache = self.cache, self.dcache
            model, dmodel = self.model, self.draft.model
            B, G, R = self.B, self.gamma + 1, self._rounds
            cols = torch.arange(self.C, device=dev)[None, :]
            dcols = torch.arange(self.Cd, device=dev)[None, :]
            steps = torch.arange(G, device=dev)
            lanes = torch.arange(B, device=dev)
            out = torch.full((B, R * G), self._pad, dtype=torch.long, device=dev)
            ncol = torch.zeros(B, dtype=torch.long, device=dev)
            left = torch.tensor([r.max_new - len(r.tokens) if r is not None else 0
                                 for r in self._slots], device=dev)
            # entry guarantee: every live lane has room for one round in both caches
            live = (torch.tensor(active, device=dev) & (cache.cursor + G <= self.C)
                    & (dcache.cursor + G <= self.Cd))
            rounds, lane_rounds = 0, torch.zeros((), dtype=torch.long, device=dev)
            while rounds < R and bool(live.any()):      # the round's one host read
                rounds += 1
                lane_rounds += live.sum()
                t_first = torch.argmax(self.logits, dim=-1)
                dcur0, dpos0 = dcache.cursor, dcache.next_pos
                tok, props = t_first, []
                for _ in range(G):
                    tok = torch.argmax(dmodel.extend_slots(dcache, tok[:, None], live)[:, 0], -1)
                    props.append(tok)
                cand = torch.stack([t_first, *props[: G - 1]], dim=1)          # [B, G]
                tcur0, tpos0 = cache.cursor, cache.next_pos
                tl = model.extend_slots(cache, cand, live)                     # [B, G, V]
                u = torch.argmax(tl, dim=-1)
                not_eos = cand != self._eos
                keep = torch.cat([not_eos[:, :1], (cand[:, 1:] == u[:, :-1]) & not_eos[:, 1:]], 1)
                n_acc = torch.cumprod(keep.long(), dim=1).sum(dim=1)          # [B]
                n_emit = torch.where(live, torch.clamp(n_acc, min=1), 0)
                # a later round's write starts at the pad tail of this one's
                out.scatter_(1, ncol[:, None] + steps,
                             torch.where(steps < n_emit[:, None], cand, self._pad))
                ncol = ncol + n_emit
                # roll both caches back to the accepted prefix
                adv = n_acc * live
                new_cur = tcur0 + adv
                cache.key_mask.masked_fill_(cols >= new_cur[:, None], 0.0)
                cache.cursor, cache.next_pos = new_cur, tpos0 + adv.to(tpos0.dtype)
                newlog = tl[lanes, torch.clamp(n_acc - 1, min=0)]
                self.logits = torch.where(live[:, None], newlog, self.logits)
                dnew = dcur0 + adv
                dcache.key_mask.masked_fill_(dcols >= dnew[:, None], 0.0)
                dcache.cursor, dcache.next_pos = dnew, dpos0 + adv.to(dpos0.dtype)
                live = (live & (t_first != self._eos) & (ncol < left) & (new_cur + G <= self.C)
                        & (dnew + G <= self.Cd))
            sp.n = rounds
            toks, counts = out.cpu().numpy(), ncol.cpu().numpy()
        self.stats["spec_rounds"] += rounds
        self.stats["spec_lane_rounds"] += int(lane_rounds)
        self.stats["spec_tokens"] += int(counts.sum())
        self.stats["spec_s"] += time.perf_counter() - t0
        return toks, counts

    def _sync_draft_lanes(self) -> None:
        """Bring every active lane's draft cache in line with its transcript
        (prompt + tokens so far): a draft prefill over its last tokens,
        windowed to leave the draft cache room for a whole quantum, for each
        lane marked dirty or short of room (JAX ``_sync_draft_lanes``). The
        draft cache moves only acceptance, never output."""
        room = self._rounds * (self.gamma + 1)
        cap = self.Cd - _round_up(room + 1, 128)
        dcur = self.dcache.cursor.cpu().numpy()
        d = self.dcache
        for b, req in enumerate(self._slots):
            if req is None:
                continue
            if not self._draft_dirty[b] and int(dcur[b]) + room <= self.Cd:
                continue             # clean, with room for a whole quantum
            toks = (req.prompt_ids + req.tokens)[-cap:]
            W = max(len(toks), 1)
            S = _round_up(W, 128)
            ids = np.full((1, S), self._pad, np.int64)
            mask = np.zeros((1, S), np.float32)
            ids[0, S - W:] = toks if toks else [self._pad]
            mask[0, S - W:] = 1.0
            _, kv = self.draft.model.prefill(torch.from_numpy(ids), torch.from_numpy(mask), S)
            d.k[:, b, :, :S] = kv.k[:, 0]
            d.v[:, b, :, :S] = kv.v[:, 0]
            if d.k_scale is not None:
                d.k_scale[:, b, :, :S] = kv.k_scale[:, 0]
                d.v_scale[:, b, :, :S] = kv.v_scale[:, 0]
            d.key_mask[b] = 0.0
            d.key_mask[b, :S] = kv.key_mask[0]
            d.cursor[b] = S
            d.next_pos[b] = kv.next_pos[0]
            self._draft_dirty[b] = False
            self.stats["draft_syncs"] += 1

    def _admit(self, ids: np.ndarray, mask: np.ndarray, slot: int, sch: int) -> None:
        """Prefill a LEFT-padded one-row prompt and copy it into ``slot``,
        whose reply decodes under schema ``sch`` (-1 = free text)."""
        S = ids.shape[1]
        logits, kv = self.model.prefill(torch.from_numpy(ids), torch.from_numpy(mask), S)
        c = self.cache
        c.k[:, slot, :, :S] = kv.k[:, 0]
        c.v[:, slot, :, :S] = kv.v[:, 0]
        if c.k_scale is not None:
            c.k_scale[:, slot, :, :S] = kv.k_scale[:, 0]
            c.v_scale[:, slot, :, :S] = kv.v_scale[:, 0]
        c.key_mask[slot] = 0.0
        c.key_mask[slot, :S] = kv.key_mask[0]
        c.cursor[slot] = S
        c.next_pos[slot] = kv.next_pos[0]
        self.logits[slot] = logits[0]
        self.dfa[slot] = 0
        self.schema[slot] = sch
        self._draft_dirty[slot] = True

    def _extend(self, toks: list, slot: int, col0: int, pos0: int, sch: int) -> None:
        """Prefill ``toks`` (RIGHT-padded to a 128 multiple) into ``slot`` at
        ``col0`` after the lane's live prefix (``Decoder.prefill_extend``);
        the reply decodes under schema ``sch``."""
        S = _round_up(len(toks), 128)
        ids = np.full((S,), self._pad, np.int64)
        mask = np.zeros((S,), np.float32)
        ids[: len(toks)] = toks
        mask[: len(toks)] = 1.0
        c = self.cache
        scales = ({} if c.k_scale is None else
                  {"k_scale_row": c.k_scale[:, slot], "v_scale_row": c.v_scale[:, slot]})
        logits, *_ = self.model.prefill_extend(
            c.k[:, slot], c.v[:, slot], c.key_mask[slot], torch.from_numpy(ids),
            torch.from_numpy(mask), col0, pos0, **scales)
        c.cursor[slot] = col0 + len(toks)
        c.next_pos[slot] = pos0 + len(toks)
        self.logits[slot] = logits
        self.dfa[slot] = 0
        self.schema[slot] = sch
        self._draft_dirty[slot] = True

    # -- scheduling ----------------------------------------------------------

    def _pick_lane(self, req: _Request) -> int | None:
        """A free lane for ``req``: its session's parked lane if possible,
        else an unowned free lane, else evict the least recently used
        parked session."""
        free = [b for b in range(self.B)
                if self._slots[b] is None and b not in self._pending]
        if not free:
            return None
        if req.session is not None:
            sess = self._sessions.get(req.session)
            if sess is not None and sess.lane in free:
                return sess.lane
        unowned = [b for b in free if self._lane_owner[b] is None]
        if unowned:
            return unowned[0]
        victim = min(free, key=lambda b: self._sessions[self._lane_owner[b]].last_use)
        self._evict(victim)
        return victim

    def _evict(self, lane: int) -> None:
        owner = self._lane_owner[lane]
        if owner is not None:
            self._sessions.pop(owner, None)
            self._lane_owner[lane] = None

    def _own(self, req: _Request, slot: int, first_col: int, toks: list) -> None:
        """Pin ``req``'s session (if any) to ``slot``."""
        if req.session is None:
            return
        old = self._sessions.pop(req.session, None)
        if old is not None and self._lane_owner[old.lane] == req.session:
            self._lane_owner[old.lane] = None     # moved to a new lane
        self._clock += 1
        self._sessions[req.session] = _Session(slot, first_col, list(toks), self._clock)
        self._lane_owner[slot] = req.session

    def _cancelled(self, req: _Request) -> bool:
        """Whether the client dropped ``req``: its future, or over a
        tensor-parallel mesh what rank 0's record of this iteration says."""
        return req.cancelled if self._group is not None else req.future.cancelled()

    def _try_admit(self, req: _Request, slot: int) -> None:
        if self._cancelled(req):
            self.stats["cancelled"] += 1   # dropped while queued: no prefill
            return
        sess = self._sessions.get(req.session) if req.session is not None else None
        if sess is not None and sess.lane == slot:
            if self._try_extend(req, sess):
                return
            self._evict(slot)    # prefix too cold / cache full: start over
        elif self._lane_owner[slot] is not None:
            self._evict(slot)    # lane reassigned to someone else

        # chunked prefill: a long prompt with co-tenants (or other pending
        # admissions) lands piece by piece; alone, monolithic is better
        toks = self.tok.encode(req.prompt)
        busy = any(s is not None for s in self._slots) or bool(self._pending)
        if busy and len(toks) > self.prefill_chunk:
            cap = self.C - 128
            if len(toks) > cap:   # keep the tail — standard chat truncation
                toks = toks[-cap:]
            self._pending[slot] = _PendingPrefill(req, list(toks))
            return

        S = min(_round_up(max(len(toks), 1), 128), self.tok.max_len)
        if S >= self.C:          # keep the tail — standard chat truncation
            S = _round_up(self.C - 128, 128)
        kept = toks[-S:]
        ids = np.full((1, S), self._pad, np.int64)
        mask = np.zeros((1, S), np.float32)
        if kept:
            ids[0, S - len(kept):] = kept
            mask[0, S - len(kept):] = 1.0
        self._admit(ids, mask, slot, self._schema_idx(req))
        self._landed(req, kept)
        self._slots[slot] = req
        self.stats["prefills"] += 1
        self._own(req, slot, S - len(kept), kept)

    def _try_extend(self, req: _Request, sess: _Session) -> bool:
        """Admit ``req`` by prefilling only the suffix past the shared token
        prefix. False -> the caller falls back to a full prefill."""
        new_toks = self.tok.encode(req.prompt)
        m = 0
        for a, b in zip(sess.tokens, new_toks):
            if a != b:
                break
            m += 1
        # always extend with >= 1 token: the lane's carried logits belong to
        # its LAST cache token, not necessarily token m-1
        m = min(m, len(new_toks) - 1)
        if m < 1:
            return False
        ext = new_toks[m:]
        col0 = sess.first_col + m
        if col0 + _round_up(len(ext), 128) >= self.C:
            return False         # no room: reset the lane via full prefill
        self._extend(ext, sess.lane, col0, m, self._schema_idx(req))
        sess.tokens = list(new_toks)
        self._landed(req, new_toks)
        self._clock += 1
        sess.last_use = self._clock
        self._slots[sess.lane] = req
        self.stats["extends"] += 1
        self.stats["prefix_tokens_reused"] += m
        return True

    def _landed(self, req: _Request, toks: list) -> None:
        """``req``'s prompt is in its lane: record admission -> here."""
        req.prompt_ids = list(toks)
        tracing.record("llm.prefill", req.t_admit_ns, time.time_ns(), rid=req.rid,
                       n=len(toks))

    def _advance_pending(self) -> None:
        """Land ONE prefill piece per pending admission. A finished one
        joins its lane like a monolithic prefill, its first real token at
        column 0. Each piece is an ``llm.piece`` span, timed on the device."""
        for slot, p in list(self._pending.items()):
            if self._cancelled(p.req):
                del self._pending[slot]    # abandon the half-built lane
                self.stats["cancelled"] += 1
                continue
            piece = p.toks[p.done: p.done + self.prefill_chunk]
            with tracing.span("llm.piece", rid=p.req.rid, n=len(piece), device=self.device):
                self._extend(piece, slot, p.done, p.done, self._schema_idx(p.req))
            p.done += len(piece)
            self.stats["prefill_pieces"] += 1
            if p.done < len(p.toks):
                continue
            del self._pending[slot]
            req = p.req
            self._landed(req, p.toks)
            self._slots[slot] = req
            self.stats["prefills"] += 1
            self._own(req, slot, 0, p.toks)

    def _harvest(self, toks: np.ndarray, counts: np.ndarray | None = None) -> None:
        """Fold one chunk's tokens into the transcripts; resolve the futures
        of lanes that hit EOS, their token budget or the cache end.
        ``counts`` (speculative quanta): each lane's emitted tokens, the
        rest of its row is not output. One ``llm.harvest`` span (a
        speculative quantum's: ``llm.spec_harvest``), ``n`` the tokens
        appended to transcripts."""
        with tracing.span("llm.harvest" if counts is None else "llm.spec_harvest") as sp:
            now = time.perf_counter()
            cursors = self.cache.cursor.cpu().numpy()
            for b, req in enumerate(self._slots):
                if req is None:
                    continue
                if self._cancelled(req):
                    # client gone: free the lane; a parked session's mirror was
                    # not extended, so its prefix stays consistent
                    self._slots[b] = None
                    self.stats["cancelled"] += 1
                    continue
                # finish reason as in the OpenAI contract: "stop" = EOS,
                # "length" = token budget or cache end
                finish = None
                for t in (toks[b] if counts is None else toks[b][: int(counts[b])]):
                    t = int(t)
                    if t == self._eos:
                        if not req.ignore_eos:
                            finish = "stop"
                            break
                        t = self._pad        # counts toward the budget, decodes to nothing
                    req.tokens.append(t)
                    sp.n += 1
                    if len(req.tokens) >= req.max_new:
                        finish = "length"
                        break
                if req.tokens and req.t_first is None:
                    req.t_first = now
                if req.on_text is not None:
                    full = self.tok.decode(req.tokens)
                    if len(full) > req.streamed:
                        try:
                            req.on_text(full[req.streamed:])
                        except Exception:
                            pass          # a broken consumer must not kill serving
                        req.streamed = len(full)
                # cache end: with a draft a lane needs room for a round's gamma + 1
                if finish is None and int(cursors[b]) >= self.C - self._margin:
                    finish = "length"
                if finish is None:
                    continue
                self.stats["tokens_out"] += len(req.tokens)
                self._lat_total.append(now - req.t_submit)
                self._lat_first.append((req.t_first or now) - req.t_submit)
                if req.session is not None:
                    sess = self._sessions.get(req.session)
                    if sess is not None and sess.lane == b:
                        # the lane parks for the session; its mirror grows by
                        # what the user saw
                        sess.tokens.extend(req.tokens)
                        self._clock += 1
                        sess.last_use = self._clock
                if self.finished is not None:
                    self.finished.append((req.rid, list(req.tokens)))
                req.future.finish_reason = finish
                req.future.token_ids = list(req.tokens)
                req.future.t_first_token = req.t_first
                req.future.t_done = now
                try:
                    req.future.set_result(self.tok.decode(req.tokens))
                except Exception:
                    self.stats["cancelled"] += 1   # cancelled meanwhile
                self._slots[b] = None

    def latency(self) -> dict:
        """Request latency and time to first token, seconds: p50/p95/p99
        over the last 8,192 finished requests."""
        def pct(xs, q):
            return float(np.percentile(list(xs), q)) if xs else None

        return {"p50_s": pct(self._lat_total, 50), "p95_s": pct(self._lat_total, 95),
                "p99_s": pct(self._lat_total, 99),
                "ttft_p50_s": pct(self._lat_first, 50),
                "ttft_p95_s": pct(self._lat_first, 95),
                "ttft_p99_s": pct(self._lat_first, 99), "n": len(self._lat_total)}

    def _arrivals(self) -> tuple[list, bool]:
        """This iteration's requests from the queue (rank 0): one per free
        lane (a cancelled one takes none), or, when the server is idle, the
        first to arrive within 50 ms (``waited``: it is admitted alone)."""
        free = sum(self._slots[b] is None and b not in self._pending for b in range(self.B))
        out: list = []
        while free:
            try:
                req = self._held.popleft() if self._held else self._queue.get_nowait()
            except queue.Empty:
                break
            req.cancelled = req.future.cancelled()
            free -= not req.cancelled
            out.append(req)
        if out or any(r is not None for r in self._slots) or self._pending:
            return out, False
        try:
            req = self._queue.get(timeout=0.05)
        except queue.Empty:
            return [], False
        req.cancelled = req.future.cancelled()
        return [req], True

    def _next(self) -> tuple[list, bool] | None:
        """The next iteration's (requests, waited), or None to stop. Over a
        tensor-parallel mesh rank 0 decides and broadcasts them, with the
        ids of the requests cancelled since, and the other ranks take them
        from its record."""
        lead = self._lead
        rec = None
        if lead:
            stop = self._stop.is_set()
            reqs, waited = ([], False) if stop else self._arrivals()
            for r in reqs:
                if not r.rid:            # a request held back keeps its number
                    self._rids += 1
                    r.rid = self._rids
            if self._group is None:
                return None if stop else (reqs, waited)
            live = [r for r in self._slots if r is not None] + [
                p.req for p in self._pending.values()]
            rec = {"stop": stop, "waited": waited,
                   "cancel": [r.rid for r in live if r.future.cancelled()],
                   "admit": [{"rid": r.rid, "prompt": r.prompt, "max_new": r.max_new,
                              "temperature": r.temperature, "top_p": r.top_p,
                              "session": r.session, "ignore_eos": r.ignore_eos,
                              "schema": r.schema, "cancelled": r.cancelled} for r in reqs]}
        data = cc.broadcast_bytes(None if rec is None else json.dumps(rec).encode(),
                                  self._group, self.device)
        if rec is None:
            rec = json.loads(data)
            reqs = [_Request(a.pop("prompt"), a.pop("max_new"), a.pop("temperature"),
                             Future(), **a) for a in rec["admit"]]
            waited = rec["waited"]
        if rec["stop"]:
            return None
        gone = set(rec["cancel"])
        for r in self._slots + [p.req for p in self._pending.values()]:
            if r is not None and r.rid in gone:
                r.cancelled = True
        return reqs, waited

    def _admit_one(self, req: _Request) -> None:
        self.stats["requests"] += 1
        req.t_admit_ns = time.time_ns()
        if req.t_submit_ns:          # rank 0, which took the request in
            tracing.record("llm.queue", req.t_submit_ns, req.t_admit_ns, rid=req.rid)
        try:
            with tracing.span("llm.admit", rid=req.rid):
                self._try_admit(req, self._pick_lane(req))
        except Exception as e:
            _fail(req.future, e)     # not in a lane yet: fail it here
            raise

    def _loop(self) -> None:
        while True:
            step = self._next()
            if step is None:
                return
            if not (step[0] or self._pending or any(r is not None for r in self._slots)):
                continue             # an idle poll: nothing to admit, land or decode
            try:
                with tracing.span("llm.tick"):
                    self._tick(*step)
            except Exception as e:   # noqa: BLE001 — containment boundary
                if self._group is None:
                    self._contain_failure(e)
                    continue
                # the ranks cannot rebuild in step: stop serving
                self.error = e
                self._fail_requests(e)
                self._stop.set()
                return

    def follow(self) -> list:
        """Run the scheduler on a model rank other than 0, in step with rank
        0's server, until that server closes; returns the last 8,192 finished
        requests as (rank 0's request number, token ids), in finishing order.
        Raises what failed an iteration here."""
        if self._lead:
            raise RuntimeError("follow() is for model ranks other than 0; rank 0 serves")
        self._loop()
        if self.error is not None:
            raise self.error
        return list(self.finished)

    def _fail_requests(self, e: Exception) -> None:
        """Fail every request in a lane or landing in pieces with ``e``."""
        self.stats["errors"] += 1
        for b, req in enumerate(self._slots):
            if req is not None:
                _fail(req.future, e)
                self._slots[b] = None
        for slot, p in list(self._pending.items()):
            _fail(p.req.future, e)
            del self._pending[slot]

    def _contain_failure(self, e: Exception) -> None:
        """A failed step (a kernel error, device OOM, a bug) must not kill
        the worker and hang every future: fail the in-flight requests with
        the error, rebuild the device state (it may be half-written), drop
        parked sessions (their lanes mirror that state), keep serving."""
        self._fail_requests(e)
        self._sessions.clear()
        self._lane_owner = [None] * self.B
        self._draft_dirty = [True] * self.B
        try:
            self._make_empty()
        except Exception:
            # the device itself is gone: stop, and fail the queued futures
            # too, or their callers would hang against a dead worker
            self._stop.set()
            while True:
                try:
                    _fail(self._queue.get_nowait().future, e)
                except queue.Empty:
                    break
            raise

    def _tick(self, arrivals: list, waited: bool) -> None:
        """One scheduler iteration: admissions (``arrivals``; one that an
        idle server ``waited`` for ends the iteration), prefill pieces, one
        decode quantum (speculative while every live lane is greedy free
        text that stops at EOS)."""
        for i, req in enumerate(arrivals):
            try:
                self._admit_one(req)
            except Exception:
                self._held.extendleft(reversed(arrivals[i + 1:]))   # admitted next time
                raise
        if waited:
            return
        self._advance_pending()
        active = [r is not None for r in self._slots]
        if not any(active):
            return                # nothing to decode; pending pieces land next time
        if self.draft is not None and all(
                r is None or (r.temperature == 0.0 and r.schema is None and not r.ignore_eos)
                for r in self._slots):
            self._sync_draft_lanes()
            toks, counts = self._spec_quantum(active)
            self.stats["chunks"] += 1
            self._harvest(toks, counts)
            return
        toks = self._decode_chunk(active)
        self.stats["chunks"] += 1
        if self.draft is not None:
            # plain quanta move lanes past their draft mirrors: resync later
            for b, a in enumerate(active):
                self._draft_dirty[b] = self._draft_dirty[b] or a
        self._harvest(toks)


def _fail(fut: Future, err: Exception) -> None:
    try:
        fut.set_exception(err)
    except Exception:
        pass                     # already cancelled or resolved


class ChatSession:
    """Multi-turn chat with prefix reuse: each ``ask()`` renders the FULL
    transcript, and the server prefills only the suffix past the lane's
    cached token prefix."""

    def __init__(self, server: LLMServer, *, template: str = "plain",
                 system_prompt: str | None = None,
                 max_new_tokens: int = 256, temperature: float = 0.0):
        import uuid

        from mediquery_rag_tpu_torch.llm.messages import system

        self.server = server
        self.id = uuid.uuid4().hex
        self.template = template
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.messages = [system(system_prompt)] if system_prompt else []

    def ask(self, text: str, **kw) -> str:
        from mediquery_rag_tpu_torch.llm.messages import ai, user
        from mediquery_rag_tpu_torch.llm.torch_client import _cut_turn, render_chat

        self.messages.append(user(text))
        prompt = render_chat(self.messages, template=self.template)
        out = self.server.complete(
            prompt, session=self.id,
            max_new_tokens=kw.get("max_new_tokens", self.max_new_tokens),
            temperature=kw.get("temperature", self.temperature))
        reply = _cut_turn(out, self.template)
        self.messages.append(ai(reply))
        return reply


class ServedLLMClient:
    """``LLMClient`` over a shared ``LLMServer``: many callers, one decode
    loop (``/qa``'s Self-RAG graph when the app serves its own decoder)."""

    def __init__(self, server: LLMServer, *, max_new_tokens: int = 256,
                 temperature: float = 0.0, template: str = "plain"):
        self.server = server
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.template = template

    def complete(self, messages, **kw) -> str:
        from mediquery_rag_tpu_torch.llm.torch_client import _cut_turn, render_chat

        schema = kw.get("schema")
        out = self.server.complete(
            render_chat(messages, template=self.template),
            max_new_tokens=kw.get("max_new_tokens", self.max_new_tokens),
            temperature=kw.get("temperature", self.temperature),
            top_p=kw.get("top_p", 1.0), schema=schema)
        if schema is not None:
            # the grammar and EOS end valid JSON; cutting at role markers
            # would corrupt a string that contains one
            return out.strip()
        return _cut_turn(out, self.template)
