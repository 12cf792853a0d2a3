#!/usr/bin/env python3
"""``chip_smoke.py`` 5c (b) on the card with each dequantized product.

    python3 tools/self_draft_card.py [--out FILE]

Runs, in one process on one CUDA card, what 5c (b) needs (phase 4 for the
near-tie bound, phase 5's store, phase 5b's 28-layer int4 + int8-KV target
and its no-draft replies), then serves 5c (b)'s 8 chats with the target
drafting for itself three times: with ``QLinear``'s dequantized int4/int8
product past 128 rows keeping the f32 sum (``ops.matmul.mm_f32``), rounded
to bf16 (the port's site, ROADMAP Queue C 7), and with the f32 sum again.
Prints, for each, the lane rounds, tokens per lane round and the replies'
departures from the no-draft ones, and the target's logit gap between its
own token and the draft's at every rejected proposal. ``--out`` writes the
same as JSON. Takes ~7 minutes on an H100.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    sys.modules["jax"] = None
    sys.modules["mediquery_rag_tpu"] = None
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("self_draft_card: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from mediquery_rag_tpu_torch.models import decoder
    from mediquery_rag_tpu_torch.ops import _build, attention, matvec, scoring
    from mediquery_rag_tpu_torch.ops.matmul import mm_f32

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    _build.build_all()
    # the keys phases 3 and 3d fill, which serve_llm adds its step times to
    results = {"phase_s": {}, "kernels_vs_plain": {"flash_decode_int8": {}, "matvec_int4": {}}}
    cs.decoder_parity(torch, results)
    counters = [scoring.flat_topk_cuda, matvec.matvec_int8_cuda, attention.flash_prefill_cuda,
                attention.flash_decode_cuda]
    gen, store = cs.serve(torch, results, counters)
    del gen
    torch.cuda.empty_cache()
    llm_counters = [matvec.matvec_int4_cuda, attention.flash_decode_int8_cuda,
                    attention.flash_prefill_int8_cuda]
    _, target, nodraft = cs.serve_llm(torch, results, counters + llm_counters, store)
    tie_gap = 2 * results["decoder_parity"]["cpu_bf16_max_logit_dev"]

    rounded = decoder.QLinear.forward

    def f32_sum(self, x, adt, layer=None, weight=None):
        rows = x.numel() // x.shape[-1]
        if self.form == "float" or rows <= decoder.MATVEC_MAX_ROWS:
            return rounded(self, x, adt, layer, weight)
        if self.form == "int4":
            wd = decoder.dequantize_weight_int4(self._int4(layer), adt)
        else:
            q, s = (self.q, self.s) if layer is None else (self.q[layer], self.s[layer])
            wd = q.to(adt) * s[:, None].to(adt)
        return mm_f32(x, wd.T, adt)

    gaps: list = []
    model = target.model
    extend = model.extend_slots

    def recording(cache, toks, live):
        logits = extend(cache, toks, live)
        if toks.shape[1] == cs.SPEC_GAMMA + 1:        # the target's verify pass
            u = logits.argmax(-1)
            keep = torch.cat([torch.ones_like(toks[:, :1], dtype=torch.bool),
                              toks[:, 1:] == u[:, :-1]], 1)
            n_acc = torch.cumprod(keep.long(), 1).sum(1)
            for b in range(toks.shape[0]):
                j = int(n_acc[b])
                if bool(live[b]) and 1 <= j < toks.shape[1]:
                    row = logits[b, j - 1].float()
                    gaps.append(float(row[u[b, j - 1]] - row[toks[b, j]]))
        return logits

    model.extend_slots = recording
    out = {"card": card, "tie_gap": tie_gap}
    for name, fwd in (("f32_sum", f32_sum), ("bf16_rounded", rounded),
                      ("f32_sum_again", f32_sum)):
        decoder.QLinear.forward = fwd
        gaps.clear()
        rec = cs.spec_chats(torch, f"5c (b) {name}", store, target, target, nodraft, tie_gap)
        rec = {k: rec[k] for k in ("spec_rounds", "spec_lane_rounds", "spec_tokens",
                                   "tokens_per_lane_round", "departures")}
        rec["reject_gaps"] = sorted(gaps)
        out[name] = rec
        print(json.dumps({"product": name, "lane_rounds": rec["spec_lane_rounds"],
                          "tokens": rec["spec_tokens"],
                          "tokens_per_lane_round": rec["tokens_per_lane_round"],
                          "rejections": len(gaps), "smallest_gaps": sorted(gaps)[:8],
                          "tie_gap": tie_gap}), flush=True)
    decoder.QLinear.forward = rounded
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
