r"""Byte-level BPE tokenizer (port of ``mediquery_rag_tpu/models/bpe_tokenizer.py``).

Loads HuggingFace ``tokenizer.json`` data: vocab, merge ranks, the
normalizer and added special tokens, and tokenizes as the JAX package does
(the GPT-2 byte<->unicode bijection, rank-greedy pair merging, specials
matched longest first and never merged across). The JAX package compiles
the pre-tokenizer pattern with the ``regex`` package; the port has no
``regex``, so the two patterns the JAX code knows are matched by hand
(:class:`_Splitter`): the GPT-2 pattern and the Qwen2 ``Split`` pattern of
Qwen2.5's ``tokenizer.json``. ``\p{L}`` and ``\p{N}`` are the Unicode
general categories L* and N* (``unicodedata``), ``\s`` is the Unicode
White_Space property (what ``regex`` matches: not ``str.isspace``, which
also takes U+001C-U+001F), and ``(?i:...)`` is simple case folding. Any
other pattern raises ``ValueError``.

Interface matches ``ByteTokenizer`` (encode/decode/batch_encode with
LEFT-padded 128-multiple batches, ``pad_id``/``eos_id``), so the
generator takes either.
"""

from __future__ import annotations

import functools
import json
import os
import re
import unicodedata

import numpy as np

# the classic GPT-2 pre-tokenizer pattern, used when tokenizer.json's
# ByteLevel pre-tokenizer has use_regex=true and no explicit Split pattern
_GPT2_PATTERN = (
    r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"
    r"|\s+(?!\S)|\s+"
)


# the Qwen2 ``Split`` pre-tokenizer pattern of Qwen2.5's tokenizer.json
_QWEN2_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?"
    r"[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)

# \s of the ``regex`` package: the Unicode White_Space property
_WHITE_SPACE = frozenset(
    [*range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
     0x2028, 0x2029, 0x202F, 0x205F, 0x3000])
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")
# simple case folding of the contractions' letters (U+017F LONG S folds to s)
_FOLD = {"S": "s", "ſ": "s", "T": "t", "R": "r", "E": "e", "V": "v",
         "M": "m", "L": "l", "D": "d"}


def _kind(ch: str) -> str:
    """'s' (\\s), 'L' (\\p{L}), 'N' (\\p{N}) or 'o' (anything else)."""
    if ord(ch) in _WHITE_SPACE:
        return "s"
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "o"


class _Splitter:
    """``finditer`` of the GPT-2 or the Qwen2 pre-tokenizer pattern, matched
    by hand: at each position the pattern's alternatives are tried in
    order, each with the backtracking the ``regex`` package would do."""

    def __init__(self, pattern: str):
        if pattern not in (_GPT2_PATTERN, _QWEN2_PATTERN):
            raise ValueError(
                f"pre-tokenizer pattern {pattern!r} is not one this tokenizer "
                "knows (the GPT-2 pattern or Qwen2's Split pattern)")
        self.qwen = pattern == _QWEN2_PATTERN

    def split(self, text: str) -> list[str]:
        kinds = [_kind(ch) for ch in text]
        out, i = [], 0
        match = self._qwen2 if self.qwen else self._gpt2
        while i < len(text):
            j = match(text, kinds, i)
            out.append(text[i:j])
            i = j
        return out

    @staticmethod
    def _run(kinds: list[str], i: int, kind: str) -> int:
        """End of the run of ``kind`` characters starting at ``i``."""
        while i < len(kinds) and kinds[i] == kind:
            i += 1
        return i

    @staticmethod
    def _contraction(text: str, i: int, fold: bool) -> int:
        """End of a contraction ('s, 't, 're, ...) at ``i``, or -1."""
        if text[i] != "'":
            return -1
        for c in _CONTRACTIONS:
            got = text[i + 1: i + 1 + len(c)]
            if fold:
                got = "".join(_FOLD.get(ch, ch) for ch in got)
            if got == c:
                return i + 1 + len(c)
        return -1

    def _space(self, kinds: list[str], i: int) -> int:
        """``\\s+(?!\\S)|\\s+`` at ``i`` (a whitespace character): the run,
        less its last character when a non-space follows and the run is
        longer than one."""
        j = self._run(kinds, i, "s")
        return j - 1 if j < len(kinds) and j - i >= 2 else j

    def _gpt2(self, text: str, kinds: list[str], i: int) -> int:
        j = self._contraction(text, i, fold=False)
        if j > 0:
            return j
        # ' ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+': an optional space, then a run
        start = i + 1 if text[i] == " " and i + 1 < len(text) and kinds[i + 1] != "s" else i
        if kinds[start] != "s":
            return self._run(kinds, start, kinds[start])
        return self._space(kinds, i)

    def _qwen2(self, text: str, kinds: list[str], i: int) -> int:
        j = self._contraction(text, i, fold=True)
        if j > 0:
            return j
        k, n = kinds[i], len(text)
        # [^\r\n\p{L}\p{N}]?\p{L}+
        if k == "L":
            return self._run(kinds, i, "L")
        if k in "so" and text[i] not in "\r\n" and i + 1 < n and kinds[i + 1] == "L":
            return self._run(kinds, i + 1, "L")
        if k == "N":                                   # \p{N}
            return i + 1
        # ' ?[^\s\p{L}\p{N}]+[\r\n]*'
        start = i + 1 if text[i] == " " and i + 1 < n and kinds[i + 1] == "o" else i
        if kinds[start] == "o":
            j = self._run(kinds, start, "o")
            while j < n and text[j] in "\r\n":
                j += 1
            return j
        # \s*[\r\n]+: up to the run's last \r or \n
        j = self._run(kinds, i, "s")
        last = max((p for p in range(i, j) if text[p] in "\r\n"), default=-1)
        if last >= 0:
            return last + 1
        return self._space(kinds, i)


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """The GPT-2 byte -> printable-unicode bijection: printable latin bytes
    map to themselves, the rest to codepoints 256+ so every byte string has
    a lossless text form that BPE can merge over."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _norm_fn(norm_cfg):
    """Build a text normalizer from the tokenizer.json ``normalizer`` node."""
    if norm_cfg is None:
        return lambda t: t
    kind = norm_cfg.get("type")
    if kind == "Sequence":
        fns = [_norm_fn(c) for c in norm_cfg.get("normalizers", [])]

        def seq(t):
            for f in fns:
                t = f(t)
            return t
        return seq
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return lambda t: unicodedata.normalize(kind, t)
    if kind == "Lowercase":
        return lambda t: t.lower()
    # Replace/Strip/etc. are not used by the byte-level BPE family; ignore
    return lambda t: t


def _pre_pattern(pre_cfg) -> str:
    """Extract the pre-tokenization regex from the ``pre_tokenizer`` node."""
    if pre_cfg is None:
        return _GPT2_PATTERN
    kind = pre_cfg.get("type")
    if kind == "Sequence":
        for c in pre_cfg.get("pretokenizers", []):
            if c.get("type") == "Split":
                return _pre_pattern(c)
        return _GPT2_PATTERN
    if kind == "Split":
        pat = pre_cfg.get("pattern", {})
        return pat.get("Regex") or pat.get("String", _GPT2_PATTERN)
    return _GPT2_PATTERN


class BPETokenizer:
    """Loads an HF-format ``tokenizer.json`` (+ optional tokenizer_config.json
    for the eos/pad token names) and tokenizes compatibly."""

    def __init__(self, tokenizer_json: dict, *, max_len: int = 4096,
                 eos_token: str | None = None, pad_token: str | None = None):
        model = tokenizer_json["model"]
        if model.get("type") != "BPE":
            raise ValueError(f"unsupported model type {model.get('type')!r}")
        self.max_len = max_len
        self.vocab: dict[str, int] = dict(model["vocab"])
        merges = model["merges"]
        # merges are "a b" strings (old format) or [a, b] pairs (new format)
        pairs = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
                 for m in merges]
        self.ranks: dict[tuple[str, str], int] = {
            p: i for i, p in enumerate(pairs)}

        self._normalize = _norm_fn(tokenizer_json.get("normalizer"))
        self._pre = _Splitter(_pre_pattern(tokenizer_json.get("pre_tokenizer")))

        self.specials: dict[str, int] = {}
        for t in tokenizer_json.get("added_tokens", []):
            self.specials[t["content"]] = t["id"]
            self.vocab.setdefault(t["content"], t["id"])
        self._special_re = (
            re.compile("|".join(
                re.escape(s)
                for s in sorted(self.specials, key=len, reverse=True)))
            if self.specials else None)

        self._byte_enc = bytes_to_unicode()
        self._byte_dec = {c: b for b, c in self._byte_enc.items()}
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self._cache: dict[str, list[int]] = {}

        def tok_id(name: str | None, *fallbacks: str) -> int | None:
            for cand in ((name,) if name else ()) + fallbacks:
                if cand in self.vocab:
                    return self.vocab[cand]
            return None

        self.eos_id = tok_id(eos_token, "<|im_end|>", "<|endoftext|>",
                             "</s>", "<|eot_id|>")
        self.pad_id = tok_id(pad_token, "<|endoftext|>", "<pad>")
        if self.pad_id is None:
            self.pad_id = self.eos_id if self.eos_id is not None else 0
        if self.eos_id is None:
            self.eos_id = self.pad_id

    def byte_token_ids(self):
        """[256] token id of each raw byte (byte-level BPE vocabs contain all
        256 single-byte tokens via the GPT-2 byte<->unicode bijection) — the
        vocab projection used by grammar-constrained decoding
        (models/constrain.py)."""
        import numpy as np
        ids = np.empty((256,), dtype=np.int32)
        for b in range(256):
            tok = self._byte_enc[b]
            if tok not in self.vocab:
                raise ValueError(
                    f"vocab lacks single-byte token for byte {b:#x} — not a "
                    "byte-level BPE tokenizer")
            ids[b] = self.vocab[tok]
        return ids

    def token_byte_table(self, vocab_size: int | None = None,
                         max_bytes: int | None = None):
        """(tok_bytes [V, L] int32, tok_len [V] int32): every token's raw
        byte expansion — the tables token-level grammar-constrained decoding
        (models/constrain.py) walks through the DFA, so an HF model emits
        schema-valid JSON with its NATIVE multi-byte tokens instead of
        byte-at-a-time. Specials get len 0 (decode() drops them, so letting
        the grammar admit their literal bytes would corrupt the output);
        so do tokens longer than ``max_bytes`` (they can never fit a finite
        grammar, and excluding them caps the walk length L)."""
        import numpy as np
        V = vocab_size or (max(self.vocab.values()) + 1)
        special_ids = set(self.specials.values())
        seqs: list[bytes] = [b""] * V
        for tok, i in self.vocab.items():
            if i >= V or i in special_ids:
                continue
            try:
                seqs[i] = bytes(self._byte_dec[c] for c in tok)
            except KeyError:
                continue        # not a byte-mapped token: never allowed
        L = max(1, max(len(s) for s in seqs))
        if max_bytes is not None and L > max_bytes:
            L = max(1, max_bytes)
        tok_bytes = np.zeros((V, L), dtype=np.int32)
        tok_len = np.zeros((V,), dtype=np.int32)
        for i, s in enumerate(seqs):
            if not s or len(s) > L:
                continue
            tok_bytes[i, : len(s)] = np.frombuffer(s, dtype=np.uint8)
            tok_len[i] = len(s)
        return tok_bytes, tok_len

    # -- constructors -------------------------------------------------------------

    @classmethod
    def from_pretrained(cls, model_dir: str, *, max_len: int = 4096
                        ) -> "BPETokenizer":
        """Load from an HF checkpoint directory (tokenizer.json [+
        tokenizer_config.json for eos/pad names])."""
        with open(os.path.join(model_dir, "tokenizer.json"),
                  encoding="utf-8") as f:
            tj = json.load(f)
        eos = pad = None
        cfg_path = os.path.join(model_dir, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path, encoding="utf-8") as f:
                tc = json.load(f)

            def name(v):
                return v.get("content") if isinstance(v, dict) else v
            eos, pad = name(tc.get("eos_token")), name(tc.get("pad_token"))
        return cls(tj, max_len=max_len, eos_token=eos, pad_token=pad)

    # -- the BPE merge loop ---------------------------------------------------------

    def _bpe(self, mapped: str) -> list[int]:
        """Greedy lowest-rank pair merging over one pre-token (already
        byte-mapped to the unicode alphabet)."""
        cached = self._cache.get(mapped)
        if cached is not None:
            return cached
        word = list(mapped)
        while len(word) > 1:
            best_rank, best_i = None, -1
            for i in range(len(word) - 1):
                r = self.ranks.get((word[i], word[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            merged = word[best_i] + word[best_i + 1]
            # merge EVERY occurrence of the winning pair (standard BPE step)
            out, i = [], 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == word[best_i]
                        and word[i + 1] == word[best_i + 1]):
                    out.append(merged)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = out
        ids = [self.vocab[t] for t in word if t in self.vocab]
        if len(self._cache) < 65536:
            self._cache[mapped] = ids
        return ids

    # -- public interface (ByteTokenizer-compatible) --------------------------------

    def encode(self, text: str, *, bos: bool = False, eos: bool = False
               ) -> list[int]:
        """Text -> ids. ``bos`` is accepted for interface parity but the
        byte-level BPE family adds no BOS (qwen2 has none)."""
        ids: list[int] = []
        segments: list[tuple[str, bool]] = []
        if self._special_re is not None:
            last = 0
            for m in self._special_re.finditer(text):
                if m.start() > last:
                    segments.append((text[last:m.start()], False))
                segments.append((m.group(0), True))
                last = m.end()
            if last < len(text):
                segments.append((text[last:], False))
        else:
            segments.append((text, False))
        for seg, special in segments:
            if special:
                ids.append(self.specials[seg])
                continue
            seg = self._normalize(seg)
            for piece in self._pre.split(seg):
                mapped = "".join(self._byte_enc[b]
                                 for b in piece.encode("utf-8"))
                ids.extend(self._bpe(mapped))
        if eos:
            ids.append(self.eos_id)
        return ids[: self.max_len]

    def decode(self, ids) -> str:
        """Ids -> text: stops at EOS, skips pad/special tokens, reverses the
        byte mapping (tolerates a truncated trailing multi-byte char)."""
        special_ids = set(self.specials.values())
        out = bytearray()
        for i in ids:
            i = int(i)
            if i == self.eos_id:
                break
            if i == self.pad_id or i in special_ids:
                continue
            tok = self.id_to_token.get(i)
            if tok is None:
                continue
            out.extend(self._byte_dec.get(ch, 0) for ch in tok)
        return out.decode("utf-8", errors="ignore")

    def batch_encode(self, texts: list[str], *, pad_to: int | None = None):
        """Left-padded batch: (ids [B,L] i32, mask [B,L] f32), L a 128
        multiple (TPU lanes) — same contract as ByteTokenizer.batch_encode."""
        encoded = [self.encode(t) for t in texts]
        longest = max((len(e) for e in encoded), default=1)
        if pad_to is None:
            length = min(-(-longest // 128) * 128, self.max_len)
        else:
            if pad_to < longest:
                raise ValueError(f"pad_to={pad_to} < longest prompt {longest}")
            length = pad_to
        ids = np.full((len(texts), length), self.pad_id, dtype=np.int32)
        mask = np.zeros((len(texts), length), dtype=np.float32)
        for r, e in enumerate(encoded):
            e = e[-length:]
            ids[r, length - len(e):] = e
            mask[r, length - len(e):] = 1.0
        return ids, mask
