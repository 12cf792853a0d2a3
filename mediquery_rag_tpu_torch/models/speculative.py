"""Speculative decoding (port of ``mediquery_rag_tpu/models/speculative.py``).

A small DRAFT model proposes ``gamma`` tokens one at a time; the TARGET
scores all of them in ONE multi-token pass
(``Decoder.prefill_extend(all_logits=True)``) and keeps the longest prefix
it agrees with, then its own next token: up to gamma + 1 tokens per target
pass, and the output is the target's own greedy continuation whatever the
draft proposes. Greedy only, as in the JAX package.

The JAX package runs the whole propose -> verify -> accept loop in one
``lax.while_loop`` on the device. Here the loop is eager Python over
tensors that stay on the device: the cursor, the position, the emitted
count and the acceptance are tensors, and each round reads the host once,
for whether to go on (``n < max_new`` and no EOS). Rejected candidates need
no eviction: ``prefill_extend`` masks every column at and after its write
column before writing, so the next round's write rolls them back.

On the CPU in f32 the output equals ``Generator.generate`` token for token.
On the card the verify pass is a multi-token forward whose bf16 rounding
differs from the one-token decode step's, so a near tie can resolve the
other way, as the JAX package notes for its TPU.
"""

from __future__ import annotations

from typing import Sequence

import torch

from mediquery_rag_tpu_torch.models.generate import Generator, _round_up


class SpeculativeGenerator:
    """A target + draft ``Generator`` pair on one device. ``generate()``
    emits the target's greedy continuation; the draft (same vocabulary)
    sets only the speed.
    ``last_stats`` holds the last call's rounds, tokens and tokens per
    round."""

    def __init__(self, target: Generator, draft: Generator, *, gamma: int = 4):
        if target.cfg.vocab_size != draft.cfg.vocab_size:
            raise ValueError("target/draft vocab mismatch")
        if gamma < 1:
            raise ValueError("gamma must be >= 1")
        self.target = target
        self.draft = draft
        self.gamma = gamma
        self.tokenizer = target.tokenizer
        self.last_stats: dict = {}

    @torch.no_grad()
    def _run(self, ids: torch.Tensor, mask: torch.Tensor, max_new: int):
        """One prompt (a left-padded row): (tokens [max_new + G] with PAD
        past the emitted ones, emitted count, rounds). The cache keeps G
        scratch columns past the budget, so a round that starts at the last
        emitted position still writes all its candidates."""
        tmodel, dmodel = self.target.model, self.draft.model
        G = self.gamma + 1
        S = ids.shape[1]
        C = _round_up(S + max_new + G, 128)
        eos, pad = int(self.tokenizer.eos_id), int(self.tokenizer.pad_id)
        t_logits, tkv = tmodel.prefill(ids, mask, C)
        _, dkv = dmodel.prefill(ids, mask, C)
        dev = tkv.k.device

        def row(kv):
            """The single lane's views: (k, v, key mask, scale rows)."""
            return (kv.k[:, 0], kv.v[:, 0], kv.key_mask[0],
                    None if kv.k_scale is None else kv.k_scale[:, 0],
                    None if kv.v_scale is None else kv.v_scale[:, 0])

        tk, tv, tkm, tks, tvs = row(tkv)
        dk, dv, dkm, dks, dvs = row(dkv)
        cur = torch.tensor(S, device=dev)          # next write column
        pos = tkv.next_pos[0].long()               # next RoPE position
        t_logits = t_logits[0]
        out = torch.full((max_new + G,), pad, dtype=torch.long, device=dev)
        n = torch.zeros((), dtype=torch.long, device=dev)
        done = torch.zeros((), dtype=torch.bool, device=dev)
        one = torch.ones(1, device=dev)
        ones_g = torch.ones(G, device=dev)
        steps = torch.arange(G, device=dev)
        rounds = 0
        while True:
            rounds += 1
            t0 = torch.argmax(t_logits)
            # the draft consumes t0 and its own gamma proposals: G extends,
            # so a fully accepted round leaves no unconsumed token behind
            tok, props = t0, []
            for i in range(G):
                dl, *_ = dmodel.prefill_extend(dk, dv, dkm, tok.reshape(1), one, cur + i,
                                               pos + i, k_scale_row=dks, v_scale_row=dvs)
                tok = torch.argmax(dl)
                props.append(tok)
            cand = torch.stack([t0, *props[: self.gamma]])            # [G]
            tl, *_ = tmodel.prefill_extend(tk, tv, tkm, cand, ones_g, cur, pos,
                                           all_logits=True, k_scale_row=tks,
                                           v_scale_row=tvs)           # [G, V]
            u = torch.argmax(tl, dim=-1)
            # EOS only ever surfaces as a round's t0: a draft equal to EOS
            # ends the accepted prefix just before itself
            not_eos = cand != eos
            keep = torch.cat([not_eos[:1], (cand[1:] == u[:-1]) & not_eos[1:]])
            n_acc = torch.cumprod(keep.long(), 0).sum()              # 0..G
            n_emit = torch.clamp(n_acc, min=1)
            out.index_copy_(0, n + steps, torch.where(steps < n_emit, cand, pad))
            t_logits = tl[torch.clamp(n_acc - 1, min=0)]
            cur, pos, n = cur + n_acc, pos + n_acc, n + n_emit
            done = done | (t0 == eos)
            if not bool((n < max_new) & ~done):     # the round's one host read
                break
        return out, int(n), rounds

    def generate(self, prompts: Sequence[str], *, max_new_tokens: int = 256) -> list[str]:
        """Greedy continuation of each prompt, one at a time (speculation
        is a latency tool; batches are ``serve/llm.py``'s job)."""
        outs = []
        rounds_total = toks_total = 0
        for prompt in prompts:
            ids, mask = self.tokenizer.batch_encode([prompt])
            S = ids.shape[1]
            # Generator.generate's budget, so the outputs match to the limit
            max_new = min(_round_up(max(max_new_tokens, 1), 64),
                          self.target.cfg.max_len - S)
            if max_new <= 0:
                raise ValueError(f"prompt ({S} tokens) leaves no room under "
                                 f"max_len={self.target.cfg.max_len}")
            out, n, rounds = self._run(torch.from_numpy(ids), torch.from_numpy(mask),
                                       max_new)
            outs.append(self.tokenizer.decode(out[:min(n, max_new_tokens)].cpu().numpy()))
            rounds_total += rounds
            toks_total += n
        self.last_stats = {"rounds": rounds_total, "tokens": toks_total,
                           "tokens_per_round": (toks_total / rounds_total
                                                if rounds_total else 0.0)}
        return outs
