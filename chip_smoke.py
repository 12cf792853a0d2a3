#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each of which raises on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of ``mediquery_rag_tpu_torch/csrc`` with nvcc;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it, with CUDA-event times of both;
4. decoder parity: a 2-layer model at the 7B-class widths, on the card
   (kernels, bf16) and on the CPU (plain versions, bf16), each held to the
   same int8 weights run in f32 on the CPU;
5. the serving path: the port's document store over ``data/medical_data.txt``,
   the 7B-class decoder (Qwen2.5-7B-Instruct widths, 28 layers, byte
   vocabulary, random int8 weights from seed 0, ``max_len`` 8192) behind
   ``TorchLLMClient``, and the shared ``SearchServer`` + Self-RAG graph on a
   free local port; two POST /search and two POST /qa over HTTP, with the
   kernels' launch counters reset just before and read just after;
6. decode tokens/s of the 7B-class decoder at batch 1 and 8, and the
   card's busy time per decode step from ``torch.profiler``.

The line before the device line is a JSON object with one entry per
kernel; the last line is ``{"ok": true, "device": {...}}``. Longer results
go to ``build/chip_smoke.json``. Without a CUDA device the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
DEVICE = "cuda"
TOPK_TOL = 1e-3          # B1 scores: f32 sums in another order
# B5/B6: |kernel - plain| <= ops.attention.attention_error_bound, per element
DECODER_RATIO = 1.5      # the card's logits may sit at most 1.5x as far (relative L2)
                         # from the f32 reference as the CPU's bf16 logits do
QUESTIONS = ["高血压患者平时饮食需要注意什么？", "糖尿病的早期症状有哪些？"]


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def post(port: int, path: str, body: dict, timeout: float = 900.0) -> tuple[dict, float]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        if r.status != 200:
            raise RuntimeError(f"{path}: HTTP {r.status}")
        payload = json.loads(r.read())
    return payload, time.perf_counter() - t0


def qwen7b_config(layers: int = 28):
    from mediquery_rag_tpu.config import DecoderConfig
    # Qwen/Qwen2.5-7B-Instruct config.json widths; the repo's byte vocabulary
    return DecoderConfig(vocab_size=384, hidden=3584, layers=layers, heads=28,
                         kv_heads=4, mlp_dim=18944, max_len=8192,
                         rope_theta=1e6, qkv_bias=True, rms_eps=1e-6,
                         dtype="bfloat16", attn_impl="flash")


def compare_kernels(torch, results: dict) -> dict:
    """Phase 3: kernel vs plain version at the serving shapes."""
    from mediquery_rag_tpu_torch.obs.metrics import cuda_time, recall_at_k
    from mediquery_rag_tpu_torch.ops import attention, matvec, scoring

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    table = {}

    # B1: flat top-k at 1M x 768 bf16, B=64, k=10
    n, d, b, k = 1 << 20, 768, 64, 10
    corpus = torch.randn((n, d), generator=gen, device=dev)
    corpus = (corpus / corpus.norm(dim=-1, keepdim=True)).to(torch.bfloat16)
    q = torch.randn((b, d), generator=gen, device=dev)
    q = (q / q.norm(dim=-1, keepdim=True)).to(torch.bfloat16)
    ks, ki = scoring.flat_topk_cuda(q, corpus, k, n)
    ps, pi = scoring.flat_search_plain(q, corpus, k, n)
    rec = recall_at_k(ki.cpu().numpy(), pi.cpu().numpy())
    err = (ks - ps).abs().max().item()
    log(f"B1 flat_topk 1Mx768 B=64 k=10: recall@10 vs plain {rec:.6f}, "
        f"max|score err| {err:.3e}")
    if rec < 0.999 or err > TOPK_TOL:
        raise RuntimeError(f"B1 disagrees: recall {rec}, err {err}")
    ms = cuda_time(lambda: scoring.flat_topk_cuda(q, corpus, k, n))
    pms = cuda_time(lambda: scoring.flat_search_plain(q, corpus, k, n), iters=3)
    log(f"B1 time: kernel {ms:.4f} ms, plain {pms:.4f} ms")
    table["flat_topk"] = {"max_abs_err": err, "ms": ms, "plain_ms": pms,
                          "recall_at_10": rec, "shape": "1Mx768 bf16 B=64 k=10"}
    del corpus

    # B4: int8 matvec on the 7B-class projections at B=1 and B=8
    shapes = {"qkv": (4608, 3584), "w_gateup": (37888, 3584),
              "w_down": (3584, 18944), "lm_head": (384, 3584)}
    mv = {}
    for name, (f, dd) in shapes.items():
        w8 = torch.randint(-127, 128, (f, dd), generator=gen, device=dev,
                           dtype=torch.int8)
        s = torch.rand((f,), generator=gen, device=dev) * 1e-3
        for bb in (1, 8):
            x8 = torch.randint(-127, 128, (bb, dd), generator=gen, device=dev,
                               dtype=torch.int8)
            out = matvec.matvec_int8_cuda(x8, w8, s)
            ref = matvec.int8_matmul_plain(x8, w8, s)
            e = (out - ref).abs().max().item()
            if e != 0.0:
                raise RuntimeError(f"B4 {name} B={bb} not bit-equal: {e}")
            t = cuda_time(lambda: matvec.matvec_int8_cuda(x8, w8, s))
            pt = cuda_time(lambda: matvec.int8_matmul_plain(x8, w8, s), iters=3)
            gbs = f * dd / (t * 1e-3) / 1e9
            log(f"B4 matvec {name} F={f} D={dd} B={bb}: bit-equal, kernel "
                f"{t:.4f} ms ({gbs:.1f} GB/s of int8 weights), plain {pt:.4f} ms")
            mv[f"{name}_B{bb}"] = {"ms": t, "plain_ms": pt, "weight_GBps": gbs}
    table["matvec_int8"] = {"max_abs_err": 0.0, "ms": mv["w_gateup_B1"]["ms"],
                            "plain_ms": mv["w_gateup_B1"]["plain_ms"],
                            "shape": "w_gateup 37888x3584 B=1", "all": mv}

    # B6: causal prefill at S=4096, 28q/4kv, dh 128, 100 left-pad columns
    B, H, KH, S, dh = 1, 28, 4, 4096, 128
    qa = torch.randn((B, H, S, dh), generator=gen, device=dev).to(torch.bfloat16)
    ka = torch.randn((B, KH, S, dh), generator=gen, device=dev).to(torch.bfloat16)
    va = torch.randn((B, KH, S, dh), generator=gen, device=dev).to(torch.bfloat16)
    mask = torch.ones((B, S), device=dev)
    mask[:, :100] = 0
    off = torch.zeros((B,), dtype=torch.int32, device=dev)
    scale = dh ** -0.5
    o = attention.flash_prefill_cuda(qa, ka, va, mask, off, scale)
    r = attention.attention_plain(qa, ka, va, mask, scale, causal=True)
    bound = attention.attention_error_bound(qa, ka, va, mask, scale, r, causal=True)
    live = mask[:, None, :, None] > 0          # rows with a visible key
    diff = (o.float() - r.float()).abs() * live
    err, ratio = diff.max().item(), (diff / bound).max().item()
    del bound, diff
    log(f"B6 flash_prefill S=4096 28q/4kv: max|err| {err:.3e}, max err/bound "
        f"{ratio:.3f}, finite {bool(torch.isfinite(o).all())}")
    if ratio > 1.0 or not torch.isfinite(o).all():
        raise RuntimeError(f"B6 disagrees: err/bound {ratio}")
    ms = cuda_time(lambda: attention.flash_prefill_cuda(qa, ka, va, mask, off, scale),
                   iters=5)
    pms = cuda_time(lambda: attention.attention_plain(qa, ka, va, mask, scale,
                                                      causal=True), iters=2)
    log(f"B6 time: kernel {ms:.4f} ms, plain {pms:.4f} ms")
    table["flash_prefill"] = {"max_abs_err": err, "err_over_bound": ratio, "ms": ms,
                              "plain_ms": pms, "shape": "B=1 S=4096 28q/4kv dh128"}
    del qa, ka, va, r

    # B5: decode attention over C=8192 at B=1 and B=8
    C = 8192
    dec = {}
    errs = []
    for bb in (1, 8):
        qd = torch.randn((bb, H, 1, dh), generator=gen, device=dev).to(torch.bfloat16)
        kc = torch.randn((bb, KH, C, dh), generator=gen, device=dev).to(torch.bfloat16)
        vc = torch.randn((bb, KH, C, dh), generator=gen, device=dev).to(torch.bfloat16)
        km = torch.zeros((bb, C), device=dev)
        for lane in range(bb):                 # left pad per lane, half the cache unwritten
            km[lane, 37 + 97 * lane:4133] = 1
        o = attention.flash_decode_cuda(qd, kc, vc, km, scale)
        r = attention.attention_plain(qd, kc, vc, km, scale, causal=False)
        bound = attention.attention_error_bound(qd, kc, vc, km, scale, r, causal=False)
        diff = (o.float() - r.float()).abs()
        e, ratio = diff.max().item(), (diff / bound).max().item()
        errs.append(e)
        if ratio > 1.0:
            raise RuntimeError(f"B5 B={bb} disagrees: err/bound {ratio}")
        t = cuda_time(lambda: attention.flash_decode_cuda(qd, kc, vc, km, scale))
        pt = cuda_time(lambda: attention.attention_plain(qd, kc, vc, km, scale,
                                                         causal=False), iters=3)
        gbs = 2 * bb * KH * C * dh * 2 / (t * 1e-3) / 1e9
        log(f"B5 flash_decode C=8192 B={bb}: max|err| {e:.3e}, max err/bound "
            f"{ratio:.3f}, kernel {t:.4f} ms ({gbs:.1f} GB/s of cache), "
            f"plain {pt:.4f} ms")
        dec[f"B{bb}"] = {"ms": t, "plain_ms": pt, "max_abs_err": e,
                         "err_over_bound": ratio, "cache_GBps": gbs}
    table["flash_decode"] = {"max_abs_err": max(errs), "ms": dec["B1"]["ms"],
                             "plain_ms": dec["B1"]["plain_ms"],
                             "shape": "C=8192 B=1 28q/4kv dh128", "all": dec}
    results["kernels_vs_plain"] = table
    return table


def decoder_parity(torch, results: dict) -> None:
    """Phase 4: a 2-layer 7B-width model on the card (kernels, bf16) and on
    the CPU (plain, bf16), each held to the same weights in f32 on the CPU,
    over a prefill and 15 decode steps fed the f32 model's greedy tokens.
    bf16 activations alone move the logits by a few percent (relative L2)
    at these widths, so the card is held to the CPU's own bf16 distance;
    its greedy token must equal the f32 one wherever the f32 top-2 margin
    exceeds twice the CPU's largest bf16 logit deviation (below that,
    bf16 rounding alone may pick the runner-up)."""
    from dataclasses import replace

    from mediquery_rag_tpu_torch.models.decoder import Decoder, init_params

    cfg = qwen7b_config(layers=2)
    params = init_params(cfg, seed=SEED, device=DEVICE, bits=8)

    def to_cpu(tree):
        return ({k: to_cpu(v) for k, v in tree.items()} if isinstance(tree, dict)
                else tree.cpu())

    cpu_params = to_cpu(params)
    models = {"card": Decoder(cfg, params), "cpu": Decoder(cfg, cpu_params),
              "f32": Decoder(replace(cfg, dtype="float32"), cpu_params)}
    gen = torch.Generator().manual_seed(SEED)
    S = 128
    ids = torch.randint(3, 259, (1, S), generator=gen)
    mask = torch.ones((1, S))
    mask[:, :9] = 0
    logits, caches = {}, {}
    for name, m in models.items():
        logits[name], caches[name] = m.prefill(ids, mask, 256)
    worst = {"card": 0.0, "cpu": 0.0}
    checked = 0
    for step in range(16):
        lg = {name: x.float().cpu() for name, x in logits.items()}
        if not torch.isfinite(lg["card"]).all() or lg["card"].shape != (1, cfg.vocab_size):
            raise RuntimeError("decoder logits not finite or misshapen")
        ref = lg["f32"]
        rel = {name: ((lg[name] - ref).norm() / ref.norm()).item() for name in worst}
        for name in worst:
            worst[name] = max(worst[name], rel[name])
        top2 = ref.topk(2, dim=-1).values[0]
        margin = (top2[0] - top2[1]).item()
        noise = (lg["cpu"] - ref).abs().max().item()
        am = {name: lg[name].argmax(-1).item() for name in lg}
        clear = margin > 2 * noise
        checked += clear
        log(f"decoder parity step {step}: vs f32 |dlogits|/|logits| card "
            f"{rel['card']:.3e}, cpu bf16 {rel['cpu']:.3e}; argmax card {am['card']} "
            f"cpu {am['cpu']} f32 {am['f32']}; f32 top-2 margin {margin:.3f}, "
            f"cpu bf16 max|dlogit| {noise:.3f}{'' if clear else ' (near tie)'}")
        if clear and am["card"] != am["f32"]:
            raise RuntimeError(f"decoder greedy token differs from f32 at step {step}")
        tok = ref.argmax(-1)
        logits = {name: m.decode_step(caches[name], tok) for name, m in models.items()}
    ratio = worst["card"] / worst["cpu"]
    log(f"decoder parity: worst vs f32 card {worst['card']:.3e}, cpu bf16 "
        f"{worst['cpu']:.3e}, ratio {ratio:.3f} (limit {DECODER_RATIO}); greedy "
        f"token checked at {checked} of 16 steps")
    if ratio > DECODER_RATIO:
        raise RuntimeError(f"decoder on the card strays from the f32 reference: {ratio}")
    if checked == 0:
        raise RuntimeError("decoder parity: no step had a clear greedy token")
    results["decoder_parity"] = {"card_rel_err": worst["card"],
                                 "cpu_bf16_rel_err": worst["cpu"], "ratio": ratio,
                                 "greedy_checked_steps": checked}


def serve(torch, results: dict, counters: list):
    """Phase 5: /search and /qa through the shared SearchServer."""
    from mediquery_rag_tpu.config import EngineConfig
    from mediquery_rag_tpu_torch.ingest import build_document_store, parse_corpus_file
    from mediquery_rag_tpu_torch.llm import TorchLLMClient
    from mediquery_rag_tpu_torch.models import Generator, IDFHashingEmbedder
    from mediquery_rag_tpu_torch.models.decoder import init_params
    from mediquery_rag_tpu_torch.serve import build_server

    corpus = os.path.join(ROOT, "data", "medical_data.txt")
    emb = IDFHashingEmbedder.fit_chunks(parse_corpus_file(corpus))
    t0 = time.perf_counter()
    store = build_document_store(corpus, emb, EngineConfig(), device=DEVICE)
    ref_store = build_document_store(corpus, emb, EngineConfig(), device="cpu")
    log(f"store: {store.live_count} chunks, corpus {tuple(store.index.corpus.shape)} "
        f"{store.index.corpus.dtype}, built in {time.perf_counter() - t0:.2f} s")
    cfg = qwen7b_config()
    t0 = time.perf_counter()
    gen = Generator(cfg, init_params(cfg, seed=SEED, device=DEVICE, bits=8),
                    device=DEVICE)
    wbytes = sum(t.numel() * t.element_size() for t in gen.model.buffers())
    log(f"7B-class decoder: {wbytes / 1e9:.3f} GB of weights on the card, "
        f"made in {time.perf_counter() - t0:.2f} s")
    llm = TorchLLMClient(gen, max_new_tokens=64)
    server = build_server(store, llm)
    try:
        port = server.start("127.0.0.1", 0)
        for fn in counters:
            fn.launches = 0
        timings = []
        for question in QUESTIONS:
            body, dt = post(port, "/search", {"query": question, "k": 5})
            got = body["results"][0]
            want = ref_store.similarity_search(question, k=5)
            if len(got) != 5 or got[0]["text"] != want[0].text:
                raise RuntimeError("/search top-1 differs from the plain store")
            overlap = len({d["text"] for d in got} & {d.text for d in want})
            serr = max(abs(g["score"] - w.score) for g, w in zip(got, want))
            log(f"POST /search {dt * 1e3:.1f} ms: top-1 equal to plain, "
                f"top-5 overlap {overlap}/5, max|score err| {serr:.2e}")
            timings.append({"path": "/search", "s": dt, "overlap": overlap})
        for question in QUESTIONS:
            body, dt = post(port, "/qa", {"question": question})
            if not isinstance(body.get("answer"), str) or not body["answer"]:
                raise RuntimeError(f"/qa returned no answer: {body}")
            if not isinstance(body.get("docs"), list):
                raise RuntimeError(f"/qa returned no docs: {body}")
            log(f"POST /qa {dt:.2f} s: answer {len(body['answer'])} chars, "
                f"{len(body['docs'])} docs")
            timings.append({"path": "/qa", "s": dt, "docs": len(body["docs"])})
        launches = {fn.__name__.removesuffix("_cuda"): fn.launches for fn in counters}
    finally:
        server.shutdown()
    log(f"launch counts over the requests: {launches}")
    missing = [name for name, n in launches.items() if n <= 0]
    if missing:
        raise RuntimeError(f"kernels not launched by the serving path: {missing}")
    results["requests"] = timings
    results["launches"] = launches
    return gen


def decode_rate(torch, gen, results: dict) -> None:
    """Phase 6: decode tokens/s of the 7B-class decoder, 64 greedy steps,
    then 16 more steps under ``torch.profiler`` for the card's busy time."""
    from mediquery_rag_tpu_torch.obs.metrics import cuda_busy

    rates = {}
    prompt = "<|user|>\n高血压患者平时饮食需要注意什么？<|end|><|assistant|>\n"
    for bb in (1, 8):
        ids, mask = gen.tokenizer.batch_encode([prompt] * bb)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = gen.model.prefill(torch.from_numpy(ids),
                                          torch.from_numpy(mask), 256)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(64):
            logits = gen.model.decode_step(cache, logits.argmax(-1))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if not torch.isfinite(logits).all() or logits.shape != (bb, gen.cfg.vocab_size):
            raise RuntimeError("7B-class decoder logits not finite or misshapen")
        tps = bb * 64 / (t2 - t1)
        step_ms = 1e3 * (t2 - t1) / 64
        log(f"decode B={bb}: prefill {ids.shape[1]} tokens {1e3 * (t1 - t0):.1f} ms, "
            f"64 steps {step_ms:.2f} ms/step, {tps:.1f} tok/s")
        tok = logits.argmax(-1)
        prof = cuda_busy(lambda: gen.model.decode_step(cache, tok), iters=16)
        if prof["busy_ms"] is None:
            log(f"decode B={bb} profile: no device records, busy time not measured")
        else:
            log(f"decode B={bb} profile (context {cache.cursor} columns): card busy "
                f"{prof['busy_ms']:.3f} ms/step, idle {1 - prof['busy_ms'] / step_ms:.1%} "
                f"of the unprofiled step, {prof['device_ops']:.0f} device ops/step")
            for name, ms, n in prof["top"]:
                log(f"    {ms:8.4f} ms x {n:5.0f}  {name}")
        rates[f"B{bb}"] = {"ms_per_step": step_ms, "tok_per_s": tps,
                           "prefill_ms": 1e3 * (t1 - t0), "profile": prof}
    results["decode"] = rates


def main() -> int:
    sys.modules["jax"] = None          # the port must run without JAX
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from mediquery_rag_tpu_torch.ops import _build, attention, matvec, scoring

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results: dict = {}
    card = card_line()
    log(f"card: {card}")
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s wall, nvcc per library "
        f"{ {k: round(v, 2) for k, v in built.items()} }")
    results["build_s"] = built
    table = compare_kernels(torch, results)
    decoder_parity(torch, results)
    counters = [scoring.flat_topk_cuda, matvec.matvec_int8_cuda,
                attention.flash_prefill_cuda, attention.flash_decode_cuda]
    gen = serve(torch, results, counters)
    decode_rate(torch, gen, results)

    sources = {
        "flat_topk": "mediquery_rag_tpu/ops/scoring.py:303",
        "matvec_int8": "mediquery_rag_tpu/ops/matvec.py:30",
        "flash_prefill": "mediquery_rag_tpu/ops/attention.py:72",
        "flash_decode": "mediquery_rag_tpu/ops/attention.py:171",
    }
    kernels = [{"name": name, "route": "cuda",
                "source": f"mediquery_rag_tpu_torch/csrc/{name}.cu",
                "replaces": sources[name], "launches": results["launches"][name],
                "max_abs_err": table[name]["max_abs_err"], "ms": table[name]["ms"],
                "plain_ms": table[name]["plain_ms"]} for name in sources]
    results["card"] = card
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
        json.dump(results, f, indent=1, ensure_ascii=False)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
