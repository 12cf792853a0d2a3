# Copy of mediquery_rag_tpu/models/constrain.py (the port imports nothing of the JAX package).
"""Grammar-constrained JSON decoding for the TPU generation engine.

The reference depends on qwen2.5 emitting parseable JSON at three seams —
follow-up decisions (structured_consultation.py:589-652), risk triage
(:835-919), health-fact extraction (health_extractor.py:72) — and fails
open when it doesn't. This module makes valid JSON a *property of the
decoder*, not a hope about the model: a restricted JSON schema is compiled
to a byte-level DFA, the DFA's transition table ships to the device as an
ordinary int32 array, and the jitted decode loop (models/generate.py) masks
each step's logits to the DFA's allowed next bytes. No per-token host round
trips (the loop stays one ``lax.while_loop``), no post-hoc repair.

Design notes, TPU-first:
- The automaton runs as two gathers per decode step (`allow[state]`,
  `next[state, sym]`) — O(1) device work, fused into the step by XLA.
- The alphabet is BYTES + EOS (257 symbols). The in-repo LM tokenizes raw
  bytes (models/byte_tokenizer.py) so constrained decoding is native; for
  HF byte-level-BPE imports the vocab projection ``tok2sym`` keeps only the
  256 single-byte tokens + EOS (guaranteed-valid JSON at byte-at-a-time
  speed — the classic grammar-decoding trade, chosen over shipping a
  [vocab x states] table at 151K-token vocabs).
- Schemas are restricted to what the app contracts need (fixed-key objects,
  bounded strings, enums, small int ranges, bounded arrays) so the whole
  grammar is REGULAR — no pushdown machinery on device.

Output is canonical JSON (no whitespace); every parser downstream
(llm/client.py:extract_json) accepts it unchanged.
"""

from __future__ import annotations

import json
from typing import Sequence

import numpy as np

EOS_SYM = 256          # DFA alphabet: 0..255 raw bytes, 256 = EOS
N_SYM = 257

# string-content bytes: anything but '"', '\', control bytes
_STR_BYTES = [b for b in range(0x20, 0x100) if b not in (0x22, 0x5C)]
_ESC_BYTES = [ord(c) for c in '"\\/bfnrt']


class _DFA:
    """NFA under construction (multi-arcs + epsilon edges are legal — e.g.
    integer literals "1"/"10" are prefix-ambiguous until the next delimiter);
    ``determinize()`` runs subset construction into real DFA tables."""

    def __init__(self):
        self.trans: list[dict[int, list[int]]] = []
        self.eps: list[list[int]] = []

    def new(self) -> int:
        self.trans.append({})
        self.eps.append([])
        return len(self.trans) - 1

    def arc(self, s: int, sym: int, t: int) -> None:
        self.trans[s].setdefault(sym, []).append(t)

    def epsilon(self, s: int, t: int) -> None:
        self.eps[s].append(t)

    def lit(self, s: int, text: bytes) -> int:
        for b in text:
            t = self.new()
            self.arc(s, b, t)
            s = t
        return s

    def alt_literals(self, s: int, options: Sequence[bytes]) -> int:
        """Each alternative is a fresh chain joined to one end by epsilon."""
        if len(set(options)) != len(options):
            raise ValueError("duplicate literals")
        end = self.new()
        for opt in options:
            if not opt:
                raise ValueError("empty literal")
            self.epsilon(self.lit(s, opt), end)
        return end

    def determinize(self, start: int, accept: int):
        """Subset construction. Returns (next_table [n, N_SYM] int32 with -1
        for disallowed, accept_set of dfa-state ids)."""
        def closure(states: frozenset) -> frozenset:
            stack, seen = list(states), set(states)
            while stack:
                for t in self.eps[stack.pop()]:
                    if t not in seen:
                        seen.add(t)
                        stack.append(t)
            return frozenset(seen)

        start_c = closure(frozenset([start]))
        ids = {start_c: 0}
        order = [start_c]
        rows = []
        i = 0
        while i < len(order):
            cur = order[i]
            i += 1
            row = {}
            for sym in {sym for st in cur for sym in self.trans[st]}:
                dst = closure(frozenset(
                    t for st in cur for t in self.trans[st].get(sym, ())))
                if dst not in ids:
                    ids[dst] = len(order)
                    order.append(dst)
                row[sym] = ids[dst]
            rows.append(row)
        table = np.full((len(order), N_SYM), -1, dtype=np.int32)
        for st, row in enumerate(rows):
            for sym, t in row.items():
                table[st, sym] = t
        accepts = {ids[c] for c in order if accept in c}
        return table, accepts


def _compile_string(dfa: _DFA, s: int, max_bytes: int) -> int:
    """Quoted JSON string, content bounded to ``max_bytes`` raw bytes.

    Budget chain ``content_i`` = "i content bytes consumed": a string byte
    steps i -> i+1, a backslash enters ``esc_i`` whose escape char lands on
    content_{i+2} (escapes cost their 2 raw bytes), '"' closes from every
    content state; at budget only '"' remains. State count is O(max_bytes).
    """
    if max_bytes < 1:
        raise ValueError("max_bytes must be >= 1")
    end = dfa.new()
    first = dfa.lit(s, b'"')
    content = [first] + [dfa.new() for _ in range(max_bytes)]
    for i in range(max_bytes + 1):
        dfa.arc(content[i], 0x22, end)
        if i < max_bytes:
            for b in _STR_BYTES:
                dfa.arc(content[i], b, content[i + 1])
        if i + 2 <= max_bytes:          # '\X' needs 2 bytes of budget
            esc = dfa.new()
            dfa.arc(content[i], 0x5C, esc)
            for b in _ESC_BYTES:
                dfa.arc(esc, b, content[i + 2])
    return end


def _compile_value(dfa: _DFA, s: int, schema: dict) -> int:
    t = schema["type"]
    if t == "boolean":
        return dfa.alt_literals(s, [b"true", b"false"])
    if t == "enum":
        return dfa.alt_literals(
            s, [b'"' + v.encode("utf-8") + b'"' for v in schema["values"]])
    if t == "integer":
        lo, hi = int(schema.get("min", 0)), int(schema.get("max", 10))
        if not (0 <= lo <= hi and hi - lo < 1000):
            raise ValueError("integer ranges are enumerated; keep them small")
        return dfa.alt_literals(
            s, [str(i).encode() for i in range(lo, hi + 1)])
    if t == "string":
        return _compile_string(dfa, s, int(schema.get("max_bytes", 100)))
    if t == "object":
        props = schema["properties"]
        if not props:
            raise ValueError("empty object schema")
        state = dfa.lit(s, b"{")
        last = len(props) - 1
        for i, (key, sub) in enumerate(props.items()):
            state = dfa.lit(state, json.dumps(key, ensure_ascii=False)
                            .encode("utf-8") + b":")
            state = _compile_value(dfa, state, sub)
            if i != last:
                state = dfa.lit(state, b",")
        return dfa.lit(state, b"}")
    if t == "array":
        items = schema["items"]
        max_items = int(schema.get("max_items", 8))
        min_items = int(schema.get("min_items", 0))
        if max_items < max(1, min_items):
            raise ValueError("max_items must be >= max(1, min_items)")
        end = dfa.new()
        state = dfa.lit(s, b"[")
        if min_items == 0:
            dfa.arc(state, ord("]"), end)
        for i in range(max_items):
            state = _compile_value(dfa, state, items)
            if i + 1 >= min_items:
                dfa.arc(state, ord("]"), end)
            if i + 1 < max_items:
                state = dfa.lit(state, b",")
        return end
    raise ValueError(f"unsupported schema type: {t}")


class JsonConstraint:
    """A schema compiled to device-ready DFA tables.

    ``next_table``: [n_states, 257] int32, -1 = disallowed symbol.
    ``tok2sym``:    [vocab] int32 mapping token id -> DFA symbol (-1 = never
                    allowed under constraint). Built from the tokenizer's
                    single-byte tokens + EOS.
    ``tok_bytes``/``tok_len``: [vocab, L]/[vocab] int32 — every token's raw
                    byte expansion. The decode loop walks ALL tokens through
                    the DFA in parallel each step (a fori_loop of gathers,
                    negligible next to the decode matmuls), so a 151K-vocab
                    HF model generates with its native multi-byte tokens —
                    full speed and on-distribution — not byte-at-a-time.
    ``eos_id``:     token id whose emission means "accept here" (legal iff
                    the current state has an EOS transition).
    """

    def __init__(self, next_table: np.ndarray, tok2sym: np.ndarray,
                 fingerprint: str, tok_bytes: np.ndarray,
                 tok_len: np.ndarray, eos_id: int):
        self.next_table = next_table
        self.tok2sym = tok2sym
        self.fingerprint = fingerprint
        self.tok_bytes = tok_bytes
        self.tok_len = tok_len
        self.eos_id = int(eos_id)
        self.n_states = next_table.shape[0]
        # the grammar is FINITE (bounded strings/arrays, no recursion), so
        # the DFA is acyclic and the longest accepting path is exact — the
        # generation budget that makes "valid by construction" literal
        # (generate.py raises max_new to cover it, incl. the EOS step)
        self.max_len_bytes = self._longest_path()

    def _longest_path(self) -> int:
        memo: dict[int, int] = {}
        on_stack: set[int] = set()

        def depth(st: int) -> int:
            if st in memo:
                return memo[st]
            if st in on_stack:
                raise AssertionError("cyclic constraint DFA (unbounded "
                                     "grammar) — budgets cannot be computed")
            on_stack.add(st)
            best = 0
            for t in self.next_table[st]:
                if t >= 0:
                    best = max(best, 1 + depth(int(t)))
            on_stack.discard(st)
            memo[st] = best
            return best

        import sys
        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, self.n_states + 100))
        try:
            return depth(0)
        finally:
            sys.setrecursionlimit(old)

    @classmethod
    def compile(cls, schema: dict, tokenizer, *,
                vocab_size: int) -> "JsonConstraint":
        nfa = _DFA()
        start = nfa.new()
        end = _compile_value(nfa, start, schema)
        accept = nfa.new()
        nfa.arc(end, EOS_SYM, accept)   # EOS legal exactly once: at the end
        next_table, accepts = nfa.determinize(start, accept)
        # state 0 is the subset-construction start (generate.py seeds 0)

        # every state must allow SOMETHING or be terminal-accepting, else
        # masking would zero the whole distribution mid-generation
        dead = [st for st in range(next_table.shape[0])
                if st not in accepts and (next_table[st] < 0).all()]
        if dead:
            raise AssertionError(f"dead DFA states: {dead}")

        byte_ids = np.asarray(tokenizer.byte_token_ids(), dtype=np.int64)
        if byte_ids.shape != (256,):
            raise ValueError("tokenizer.byte_token_ids() must map all 256")
        tok2sym = np.full((vocab_size,), -1, dtype=np.int32)
        tok2sym[byte_ids] = np.arange(256, dtype=np.int32)
        tok2sym[int(tokenizer.eos_id)] = EOS_SYM

        c = cls.__new__(cls)
        c.next_table = next_table
        c.n_states = next_table.shape[0]
        max_len = c._longest_path()
        # tokens longer than the grammar's longest path can never be fully
        # consumed — dropping them up front caps the per-step walk length
        tok_bytes, tok_len = tokenizer.token_byte_table(
            vocab_size=vocab_size, max_bytes=max_len)
        # deadlock-freedom: all 256 single-byte tokens present (asserted by
        # byte_token_ids above), so any state with an outgoing byte arc has
        # at least one allowed token
        import hashlib
        fp = hashlib.sha1(json.dumps(schema, sort_keys=True).encode()
                          ).hexdigest()[:12] + f"-{next_table.shape[0]}"
        return cls(next_table, tok2sym, fp, tok_bytes, tok_len,
                   int(tokenizer.eos_id))

    def accepts(self, text: str) -> bool:
        """Host-side check: does ``text`` (+EOS) drive the DFA to accept?
        Used by tests and by callers validating foreign output."""
        st = 0
        for b in text.encode("utf-8"):
            st = int(self.next_table[st, b])
            if st < 0:
                return False
        st = int(self.next_table[st, EOS_SYM])
        return st >= 0


# -- the app-layer contracts (reference JSON seams) ---------------------------

# structured_consultation.py:589-652 follow-up decision
FOLLOWUP_SCHEMA: dict = {
    "type": "object",
    "properties": {
        "need_followup": {"type": "boolean"},
        "question": {"type": "string", "max_bytes": 120},
        "options": {"type": "array", "max_items": 4,
                    "items": {"type": "string", "max_bytes": 40}},
        "reason": {"type": "string", "max_bytes": 80},
    },
}

# structured_consultation.py:835-919 triage-nurse risk JSON
RISK_SCHEMA: dict = {
    "type": "object",
    "properties": {
        "risk": {"type": "enum",
                 "values": ["CRITICAL", "HIGH", "MEDIUM", "LOW"]},
        "severity": {"type": "integer", "min": 0, "max": 10},
        "reason": {"type": "string", "max_bytes": 80},
    },
}

# health_extractor.py:24-50 extraction array
EXTRACT_SCHEMA: dict = {
    "type": "array",
    "max_items": 8,
    "items": {
        "type": "object",
        "properties": {
            "category": {"type": "enum",
                         "values": ["allergy", "medication", "disease",
                                    "lifestyle", "basic"]},
            "content": {"type": "string", "max_bytes": 100},
            "important": {"type": "boolean"},
        },
    },
}
