"""A Qwen2-class decoder served by the port's ``LLMServer``.

Set-up makes the raw weights on the device from the seed in the dtype the
configuration serves (``weights.qwen2_params``), builds ``Generator`` from
them, quantizes it as the deployment states and starts ``LLMServer``.
Requests go in through ``LLMServer.submit`` (greedy, ``ignore_eos``, so
each decodes exactly its budget); the future carries its token ids and
the server's first-token and done times.

``check`` runs after the window, once the server and its cache are freed:
it takes a sample, drawn from the seed, of the requests that finished
inside the window, with the longest of them in it, and runs
``reference.qwen2`` over each prompt and its served tokens (a window in
which none finished fails the run). ``logit_gap`` is the widest gap by
which a served token's reference logit lies below the reference's best at
that position. With ``control``, the reference at one precision step down
(fp8 activations, int4 KV) is put in the program's place: its
``logit_gap`` is the gap of the token it puts first. A request that decoded past an EOS reports a
PAD id where the EOS was, so a served PAD is read as whichever of PAD and
EOS the reference ranks higher.
"""

from __future__ import annotations

import gc
import random

import torch

from perfbench.harness import roofline, weights
from perfbench.harness.trace import LaunchProbe
from perfbench.reference import qwen2 as ref

PAD, EOS = 0, 2


def model_shape(cfg: dict) -> dict:
    return {"hidden": cfg["hidden_size"], "layers": cfg["num_hidden_layers"],
            "heads": cfg["num_attention_heads"], "kv_heads": cfg["num_key_value_heads"],
            "mlp_dim": cfg["intermediate_size"], "vocab": cfg["vocab_size"],
            "rope_theta": cfg["rope_theta"], "rms_eps": cfg["rms_norm_eps"],
            "dtype": cfg["torch_dtype"]}


class System:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from mediquery_rag_tpu_torch.config import DecoderConfig
        from mediquery_rag_tpu_torch.models.generate import Generator
        from mediquery_rag_tpu_torch.serve.llm import LLMServer

        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.shape = model_shape(cfg)
        dep = cfg["deployment"]
        dcfg = DecoderConfig(
            vocab_size=cfg["vocab_size"], hidden=cfg["hidden_size"],
            layers=cfg["num_hidden_layers"], heads=cfg["num_attention_heads"],
            kv_heads=cfg["num_key_value_heads"], mlp_dim=cfg["intermediate_size"],
            max_len=dep["cache_len"], rope_theta=cfg["rope_theta"], qkv_bias=True,
            rms_eps=cfg["rms_norm_eps"], dtype=cfg["torch_dtype"],
            param_dtype=cfg["torch_dtype"], kv_dtype=dep["kv_dtype"], attn_impl=dep["attn_impl"])
        gen = Generator(dcfg, weights.qwen2_params(self.shape, seed, device), device=device)
        gen.quantize_weights(dep["weight_bits"])
        self.gen = gen
        self.srv = LLMServer(gen, slots=cfg["slots"], chunk=dep["chunk"],
                             prefill_chunk=dep["prefill_chunk"], cache_len=dep["cache_len"],
                             seed=seed)

    # -- the loop's interface ---------------------------------------------------

    def submit(self, req: dict):
        return self.srv.submit(req["prompt"], max_new_tokens=req["max_new"], temperature=0.0,
                               ignore_eos=True)

    def outcome(self, rec, fut, t: float) -> dict:
        if fut.exception() is not None:
            return {"ok": False, "t_done": t, "error": repr(fut.exception())}
        ids = list(fut.token_ids)
        out = {"t_first": fut.t_first_token, "t_done": fut.t_done, "n_out": len(ids),
               "payload": ids, "ok": len(ids) == rec.req["max_new"]}
        if not out["ok"]:
            out["error"] = f"{len(ids)} tokens for a budget of {rec.req['max_new']}"
        return out

    def counters(self) -> dict:
        return dict(self.srv.stats)

    def spans(self) -> list:
        return []

    def probes(self) -> dict:
        """B7 and B5 int8 launches, with what each launch's operands need."""
        from mediquery_rag_tpu_torch.ops import attention, matvec

        def b7(x8, corr, q4, s):
            rows, d = x8.shape
            f = 2 * q4.shape[0]
            return roofline.b7_bytes(rows, f, d), roofline.b7_ops(rows, f, d)

        seen = {"key": None, "cols": None}

        def b5(q, k8, v8, k_scale, v_scale, key_mask, scale, *, fresh_k=None, **_):
            key = (key_mask.data_ptr(), key_mask._version)
            if seen["key"] != key:          # one count a step: its layers share the mask
                seen["key"], seen["cols"] = key, (key_mask > 0).sum()
            lanes, heads, _, dh = q.shape
            kw = dict(lanes=lanes, heads=heads, dh=dh, live_cols=seen["cols"])
            return (roofline.b5_int8_bytes(kv_heads=k8.shape[1], cache_cols=k8.shape[2],
                                           fresh=fresh_k is not None, **kw),
                    roofline.b5_ops(**kw))

        return {"b7": LaunchProbe(matvec, "matvec_int4_cuda", "matvec_int4_kernel", "int8", b7),
                "b5": LaunchProbe(attention, "flash_decode_int8_cuda", "flash_decode_kernel",
                                  "bf16", b5)}

    def close(self) -> None:
        self.srv.close()
        del self.srv, self.gen
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # -- the comparison with the reference ----------------------------------------

    def check(self, records: list, w0: float, w1: float, control: bool) -> dict:
        done = [r for r in records if r.ok and w0 <= r.t_done < w1]
        if not done:
            raise RuntimeError("no request finished inside the window: nothing to check")
        n = self.traffic["check_requests"]
        longest = max(done, key=lambda r: r.req["prompt_tokens"] + r.n_out)
        rest = [r for r in done if r is not longest]
        sample = [longest] + random.Random(self.seed ^ 0x51C4).sample(rest, min(n - 1, len(rest)))
        seqs, positions, served = [], [], []
        for r in sample:
            p = ref.byte_ids(r.req["prompt"])
            seqs.append(p + list(r.payload))
            positions.append(list(range(len(p) - 1, len(p) - 1 + len(r.payload))))
            served.append(list(r.payload))
        logits = ref.logits_at(self.shape, self.seed, seqs, positions, self.device)
        gaps, best = [], []
        for lg, toks in zip(logits, served):
            top = lg.max(dim=1).values
            t = torch.tensor(toks, device=lg.device)
            got = lg.gather(1, t[:, None])[:, 0]
            eos = lg[:, EOS]
            got = torch.where(t == PAD, torch.maximum(got, eos), got)
            gaps.append(top - got)
            best.append(top)
        limit = self.cfg["check"]["logit_gap"]
        out = {"program": [{"name": "logit_gap", "value": float(torch.cat(gaps).max()),
                            "limit": limit, "tokens": sum(len(s) for s in served),
                            "requests": len(sample)}]}
        if control:
            ctl = ref.logits_at(self.shape, self.seed, seqs, positions, self.device,
                                precision="control")
            cg = [top - lg.gather(1, c.argmax(dim=1)[:, None])[:, 0]
                  for lg, c, top in zip(logits, ctl, best)]
            out["control"] = [{"name": "logit_gap", "value": float(torch.cat(cg).max()),
                               "limit": limit}]
        return out


def build(cfg: dict, traffic: dict, seed: int, device) -> System:
    return System(cfg, traffic, seed, device)
