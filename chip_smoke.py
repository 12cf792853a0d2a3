#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each of which raises on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of ``mediquery_rag_tpu_torch/csrc`` with nvcc;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it, with CUDA-event times of both and of
   the one PyTorch call that computes the same function where there is one
   (``scaled_dot_product_attention`` for B5 and B6; B5 and its SDPA queued
   behind a sleeping kernel, so the host's launch rate does not enter, with
   a cold L2, in turn over copies of the cache whose bytes pass twice the
   L2 between two uses of one, as a decode step's 28 layer caches do, and
   warm beside it); B1 over bf16 and over
   f32 (TF32 off for the plain product) and B2/B3, the int8/int4 scans, at
   1M x 768, B=64, k=10 (and k=40 for B2/B3), each scan with the share of
   scores that pass its in-register filter and its merge rounds per block;
3c. the IVF kernels (B8a/B8b/B8c query-major, B9a/B9b/B9c bucket-major) on
   ``IVFIndex`` builds of 1M x 768 clustered unit rows (bf16 twice, to hold
   the build to one result per seed, f32 (B8a/B9a over f32 buckets; the
   index also adds 5 rows, finds each first, and deletes them), and int8
   and int4 with ``rerank_factor=4``; nlist 1,024, nprobe 32),
   each against its plain version at B=1 and B=64, k=10, 20 and 40 (the
   Hopper IVF scans, B8a/B9a and B8b/B8c, read each bucket's live extent,
   kept by the index), with both layouts timed at B = 1, 8, 16, 32, 64 and 256 and
   recall@10 of
   ``IVFIndex.search`` against the exact f32 scan on held-out queries
   (>= 0.9; int4 at a 120-candidate rerank, and at its served 40
   candidates within 0.02 of flat int4's at the same rerank);
3d. the kernels of the LLM serving path: B7 ``matvec_int4`` at every
   7B-class projection, 1, 4, 8, 20 and 128 rows (bit-equal expected; timed
   cold, rotating over copies of the weights, with the 28-layer step's
   sum); B5 over an int8
   cache with the fresh-column fold (C=8192 half valid, B=1 and 4); B6
   over an int8 cache (a 256-token piece at column 2048); each against
   its plain version, beside SDPA over the same cache dequantized to bf16
   (B5 and its SDPA with a cold L2, as in phase 3);
4. decoder parity: a 2-layer model at the 7B-class widths, on the card
   (kernels, bf16) and on the CPU (plain versions, bf16), each held to the
   same int8 weights run in f32 on the CPU;
4b. the same for int4 weights and an int8 KV cache: prefill of 4 lanes,
   7 ``decode_step_slots`` steps with one lane inactive, one 256-token
   ``prefill_extend``;
5. the serving path: the port's document store over ``data/medical_data.txt``,
   the 7B-class decoder (Qwen2.5-7B-Instruct widths, 28 layers, byte
   vocabulary, random int8 weights from seed 0, ``max_len`` 8192) behind
   ``TorchLLMClient``, and the port's ``SearchServer`` + Self-RAG graph on a
   free local port; two POST /search and one POST /qa over HTTP, with the
   kernels' launch counters reset just before and read just after;
5b. the LLM serving path as ``serve.main`` wires it over phase 5's store:
   the 7B-class decoder with int4 weights and an int8 KV cache (max_len
   8192) behind ``LLMServer`` (4 slot lanes); 4 short prompts alone and
   together, 32 tokens each (token-identical), 8 concurrent POST
   /v1/chat/completions of 64 tokens (4 streamed) with prompts of 300 to
   3,000 byte tokens, a 3-turn ``ChatSession``, one POST /qa through
   ``ServedLLMClient`` and a second /qa graph run, for a logged-in user,
   whose health-profile extraction decodes under ``EXTRACT_SCHEMA``
   through the server (the reply must be JSON the schema accepts, no
   extraction error logged); time to first token, tokens/s, ms per step,
   the card's busy time per step (with B5's device ms per launch in the
   step, over the server's own caches), and the constrained step's host ms
   against the free one;
5c. speculative serving over 5b's target: (a) B5 with its (m, l) outputs
   against plain at the verify shapes (G = 5 rows per lane, B = 4, C = 8192
   half valid, int8 and bf16 caches; o per element within the bound, m
   within ML_M_TOL, l within ML_L_REL relative, and the context folded with
   a G x G fresh block as ``extend_slots`` does, per element), timed beside
   SDPA (output only), both with a cold L2 as in phase 3; (b) the 8 chats of 5b (32 tokens each) through
   ``build_app_server`` with the target as its own draft (gamma 4): at
   least 4.0 tokens per lane round; (c) a 2-layer draft at the 7B widths distilled by
   ``distill_draft`` (30 epochs over the target's greedy continuations of
   those prompts, B6 forward and B10a/B10b backward), saved, loaded int4 by
   ``serve.server.load_draft`` as ``serve.main --draft DIR
   --draft-quantize 4`` loads it, and served the same way. Every reply of
   (b) and (c) equals the first 32 tokens of 5b's no-draft reply or
   departs from them first at a near tie (the two tokens' logits within
   twice phase 4's largest bf16 logit deviation of the maximum, phase 4's
   own rule); tokens per lane round, host ms per round, tok/s per lane and
   the launches of B5 (m, l), B6, B7, B10a and B10b are reported;
6. the quantized retrieval path: an int8 store and an int4 store with
   ``rerank_factor=4`` (the corpus plus synthetic unit rows, 131,072 rows
   at 3,072 dims), each served over HTTP: two POST /search held to the same
   store on the CPU, POST /documents then /search, POST /documents/delete
   then /search, and ``search_stream`` held bit-equal to ``search``, with
   the launch counters reset just before and read just after;
6b. the IVF retrieval path: f32 and bf16 IVF stores and int8 and int4 IVF
   stores with ``rerank_factor=4`` over phase 6's rows, each held to its own saved
   index loaded on the CPU, served over HTTP: two POST /search, one with
   64 queries, or as many as the card's layout rule needs for the
   bucket-major layout (``ops.ivf_kernel.ivf_layout_threshold``; it must
   launch the store's bucket-major kernel; top-5 held to the CPU store but
   for near ties), one POST /qa, POST /documents and /documents/delete,
   with the launch counters reset just before and read just after; before
   serving, each store's two kernels against their plain versions on its
   own index at B=1 and 64, k=5 and 20 (launches not counted);
6c. the streaming tiers: ``IVFIndex.build_streaming`` from host chunks
   held bucket for bucket to ``build`` (196,608 rows, bf16/int8/int4), at
   1M x 768 int4 with its phase timings and recall@10 within 0.01 of phase
   3c's in-memory index, and ``StreamingFlatIndex`` (int8 over 4M x 768
   rows in four 2^20-row chunks, bf16 over 1M) held to a resident
   ``FlatIndex`` on the card (bf16 also to the plain f32 product) and
   timed with and without prefetch against the host link's measured rate
   (one pinned 1 GiB copy); each search alone between the counter reset
   and read, launching its scan once per chunk;
7. decode tokens/s of the 7B-class decoder at batch 1 and 8 (16 steps),
   and the card's busy time per decode step from ``torch.profiler``;
8. the training path at the repo's 1B-class widths (hidden 2048, 16
   layers, 16 MHA heads, SwiGLU 5632, byte vocabulary, flash attention):
   8a B10a/B10b (``csrc/flash_backward.cu``) against the plain backward at
   S=4096, B=1, 1B-class and 7B-class GQA (28/4) heads, beside SDPA's
   backward; 8b the ``lm_loss`` gradient of a 2-layer model on the card
   (flash and einsum paths) and on the CPU in bf16, each held to f32 on the
   CPU; 8c B6, B10a and B10b held to plain and timed beside SDPA at the
   training step's own shape (B=8, 16 heads, the first batch's right-padded
   mask), then ``LMTrainer`` (AdamW, ``remat=True``, B=8) for 10 steps at
   full depth over ``data/medical_data.txt`` with random weights from seed 0:
   the loss falls, each step launches B6 twice per layer and B10a/B10b
   once (counters reset before each step), ms/step, tokens/s, MFU and a
   profile of the step; 8d one gradient step at S=4096 through the flash
   and the einsum paths (ms, peak memory); 8e three ``LoraTrainer`` steps
   on the trained base (base bit-unchanged), the merged model saved,
   reloaded and decoded with int8 weights through B4;
9. the consultation CLI over HF checkpoints written here by hand into a
   temporary directory under ``build/`` (deleted at the end): one of
   Qwen2.5-7B-Instruct's shape (28 layers, hidden 3584, 28/4 heads, q/k/v
   biases, vocab 152,064, untied, seeded random bf16 weights in 4 shards
   with ``model.safetensors.index.json``; a byte-level BPE
   ``tokenizer.json`` with Qwen2's pre-tokenizer pattern, merges learned
   from the corpus by a counting loop, Qwen's three specials) and a
   bert-base-chinese-shaped BERT (12 layers, 768, vocab 21,128 from the
   corpus's characters). ``AppContext.build`` on the card with
   ``MEDIQUERY_HF_LLM`` (int4 weights, int8 KV cache) and
   ``MEDIQUERY_HF_EMBEDDER``: load and quantize seconds, peak device
   memory, 64 sampled checkpoint tensors bit-equal on the card before
   quantization; BPE ``decode(encode(t)) == t`` for every corpus chunk;
   ``cli.interface.main_menu`` driven in-process with scripted input (a
   structured consultation through triage and follow-up, a science
   question, exit) with the launch counters reset just before and read
   just after (B1, B7, B6 and B5 int8 must rise: the lockstep prefill
   attends over its fresh K/V in bf16), every triage, follow-up
   and extraction reply parsed under its schema, tokens/s of the answers
   and host ms per constrained step over the 152,064-token vocabulary; the
   BERT store's top-10 held to a CPU run of the port's plain path over the
   same checkpoint but for ties; and the 7B-width int8 HF model at 2
   layers held to f32 on the CPU by phase 4's rule;
10. the encoders and the grader, after Queue C 7's repair, in an app
   directory under ``build/`` (deleted at the end): (a) ``ops.matmul.mm_f32``
   (bf16 operands, f32 sum: cuBLAS through ``aten::mm.dtype``) at 4,096 x
   3,584 -> 18,944 against an f64 product of the same operands within the
   f32 sum-order bound, timed beside the bf16-output product and the f32
   SGEMM, phase 4's bf16 ratio, and a 2-layer 7B-width decoder with bf16
   float weights held to f32 by phase 4's rule; (b) a full-width
   ``TextEmbedder`` (``EmbedderConfig()``, seeded weights): save and
   ``from_checkpoint`` bit-equal, the 160 corpus chunks at the ingest batch
   against the port on the CPU (per-row cosine >= EMBED_COS_MIN), host ms
   per query at B=1 and chunks/s; (c) ``AppContext.build`` with
   ``MEDIQUERY_HYBRID=1`` over that checkpoint: the hybrid store's top-10
   against the same store on the CPU but for near ties, B1 launches counted,
   ``SimilarityGrader`` at 0.2; (d) ``train_grader`` for one epoch at its
   defaults, the context's ``TrainedGrader`` answering one /qa graph run with
   the scripted LLM, its logits against the CPU; (e) 10
   ``ContrastiveTrainer`` steps at ``EmbedderConfig()``, batch 8,
   ``remat=True``: ms per step, tokens/s, MFU, peak memory, the first
   loss against the CPU;
11. the sharded retrieval path, run right after 3c over its IVF indexes
   and its rows made again from the seed, with 4 shards sharing the card
   (``corpus_mesh(4, devices=[cuda:0] * 4)``): ``ShardedFlatIndex`` bf16,
   f32, int8 and int4 over 1M x 768 rows (and ``slice_mesh(2, 2)``, and a
   3,000-row corpus whose last shards hold no valid row) and
   ``ShardedIVFIndex.from_single`` over 3c's bf16, int8 and int4 indexes in
   both layouts (and a batch whose every probe lies on shard 0), each
   search bit-equal to the single-card index's scan and launching its
   kernel once a shard; sharded checkpoints saved on 4 shards and loaded
   onto one; a ``torch.profiler`` trace of one sharded search holding its
   ``obs.span`` and the 4 scan launches; sharded and single-card
   search times at B=64;
12. the trainers' data/model mesh, run right after 8: ``LMTrainer(mesh=)``
   at the 1B-class widths cut to 4 layers, B=8 over the corpus, AdamW,
   ``remat=True``: (a) a world-size-1 NCCL mesh, 3 steps, against
   ``LMTrainer(mesh=None)`` from the same init (at world size 1 every
   collective is the identity, so no NCCL call runs); (b) 2 ranks spawned
   on the one card over gloo (NCCL refuses two ranks on one card), tp=2
   and then dp=2, 2 steps each, held to (a)'s losses and parameters, each
   after B6/B10a/B10b are held per element to plain at the rank's own
   heads and rows; each rank's B6/B10a/B10b launches per step checked; ms
   a step and peak memory per rank;
13. tensor-parallel generation, run right after 12, at Qwen2.5-7B's widths
   and depth (phase 5b's config, seed-0 weights) over 2 gloo ranks on the
   one card (each rank 14 query / 2 KV heads): the world-size-1 runs first
   in this process, then one spawn; (a) int4 weights + an int8 KV cache,
   ``Generator(mesh=).generate_tokens`` of 2 prompts (one of 217 tokens) x
   32 greedy tokens; (c) ``LLMServer`` on rank 0 with rank 1 following, 4
   requests of 300-1,500 bytes, three landing in 256-token pieces; (b)
   int8 weights, 8 tokens. On each rank B7 (B4 in (b)) at a column cut, two
   row cuts and the vocab cut, bit-equal, and B6 and B5 int8 per element
   to plain at the rank's shapes on the inputs of a real step; tokens of
   every run equal world size 1's or part first at a near tie (5c's
   bound); the follower's finished requests equal rank 0's; launches per
   decode step checked (B7 5L + 1, B5 int8 L; B4 4L + 1); ms a decode step,
   peak memory, tok/s and TTFT beside world size 1. gloo stages each
   collective through the host: its times are not NVLink's.

Each phase prints its seconds.

The line before the device line is a JSON object with one entry per
kernel (its time, its plain version's, the library call's, and its bound:
the larger of the bytes it must move over 3.35 TB/s and its operations over
the card's peak for their type); the last line is
``{"ok": true, "device": {...}}``. Longer results go to
``build/chip_smoke.json``. Without a CUDA device the script exits non-zero
and prints no result. Neither JAX nor ``mediquery_rag_tpu`` is imported.
"""

from __future__ import annotations

import collections
import json
import math
import os
import subprocess
import sys
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
DEVICE = "cuda"
TOPK_TOL = 1e-3          # B1 scores: f32 sums in another order
F32_TOL = 5e-5           # B1 f32 on unit rows: the f32 sum bound D * 2^-24 at D = 768
QUANT_REL_TOL = 1e-6     # B2/B3 scores: exact integer sums, the same f32 operations
HBM_BPS = 3.35e12        # H100 SXM data sheet: HBM3 bytes/s
# H100 SXM data sheet, 700 W: dense tensor-core rates, and f32 on the CUDA cores
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
# B5/B6: |kernel - plain| <= ops.attention.attention_error_bound, per element
DECODER_RATIO = 1.5      # the card's logits may sit at most 1.5x as far (relative L2)
                         # from the f32 reference as the CPU's bf16 logits do
QUESTIONS = ["高血压患者平时饮食需要注意什么？", "糖尿病的早期症状有哪些？"]
QA_TOKENS = 32           # phases 5 and 5b: the graph's reply budget per LLM call of a /qa
                         # (64 before PR 15; cut for the run's time, the widths are not)
PARITY4B_STEPS = 7       # phase 4b: decode_step_slots steps held to f32 (15 before PR 15)
SPEC_GAMMA = 4           # phase 5c: draft tokens per verify round (serve --gamma's default)
DISTILL_EPOCHS = 30      # phase 5c: distill's CLI default (one step per epoch here)
SPEC_TOKENS = 32         # phase 5c: tokens per chat, held to the first 32 of 5b's 64 (the
                         # depth is cut for the run's time; greedy prefixes do not depend
                         # on the budget)
# B5's (m, l) against plain on the card: m is a max of logits, each a sum of dh = 128
# products taken in another order (at most dh 2^-24 sum|q k| scale: 5.5e-5 for these
# bf16 inputs and int8 codes at their scales); l is a sum of up to 8,192 positive
# terms in another order (relative n 2^-24 = 4.9e-4) of weights carrying that error
ML_M_TOL = 1e-4
ML_L_REL = 1e-3


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


def roofline(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    """Least time for the work on an H100 (ms) and what bounds it."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed_cold(call, copies: list) -> tuple[float, float]:
    """(cold, warm) ms of ``call(*c)`` on the card, queued behind a sleeping
    kernel so the host's launch rate does not enter: cold in turn over
    ``copies`` of its inputs, each out of the L2 when its turn comes
    (``obs.cuda_time_cold``; a decode step reads 28 layer caches), warm on
    the first copy alone."""
    from mediquery_rag_tpu_torch.obs.metrics import cuda_time_cold, cuda_time_warm
    return (cuda_time_cold([lambda c=c: call(*c) for c in copies]),
            cuda_time_warm(lambda: call(*copies[0])))


def qwen7b_config(layers: int = 28):
    from mediquery_rag_tpu_torch.config import DecoderConfig
    # Qwen/Qwen2.5-7B-Instruct config.json widths; the repo's byte vocabulary
    return DecoderConfig(vocab_size=384, hidden=3584, layers=layers, heads=28,
                         kv_heads=4, mlp_dim=18944, max_len=8192,
                         rope_theta=1e6, qkv_bias=True, rms_eps=1e-6,
                         dtype="bfloat16", attn_impl="flash")


def scan_filter_stats(torch, kern, args: tuple, k: int, n: int, b: int, plan) -> dict:
    """One more launch of a flat scan with its ``stats`` hook: the share of
    the b x n scores that passed the in-register filter and the merge
    rounds per block (the launch is a measurement, before any counter
    reset)."""
    stats = torch.zeros(2, dtype=torch.int32, device="cuda")
    kern(*args, k, n, stats=stats)
    return {"survivors_share": stats[0].item() / (b * n),
            "merges_per_block": stats[1].item() / (plan.ranges * plan.groups)}


def compare_kernels(torch, results: dict) -> dict:
    """Phase 3: kernel vs plain version at the serving shapes."""
    from mediquery_rag_tpu_torch.obs.metrics import cold_copies, cuda_time, recall_at_k
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
    bms, by = roofline(n * d * 2 + b * d * 2 + b * k * 8, 2 * b * n * d, "bf16")
    filt = scan_filter_stats(torch, scoring.flat_topk_cuda, (q, corpus), k, n, b,
                             scoring.flat_scan_plan(b, d, n, k))
    log(f"B1 time: kernel {ms:.4f} ms, plain {pms:.4f} ms, bound {bms:.4f} ms ({by}), "
        f"{bms / ms:.1%} of it, {filt['survivors_share']:.3%} of scores survive the filter, "
        f"{filt['merges_per_block']:.1f} merges a block")
    table["flat_topk"] = {"max_abs_err": err, "ms": ms, "plain_ms": pms,
                          "bound_ms": bms, "bound_by": by, "library_ms": None,
                          "recall_at_10": rec, "shape": "1Mx768 bf16 B=64 k=10", **filt}
    del corpus

    # B1 f32: 1M x 768 f32 unit rows, B=64, k=10; the plain product in full
    # f32 (TF32 off: main() sets it, and it is set again here)
    torch.backends.cuda.matmul.allow_tf32 = False
    g32 = torch.Generator(device=dev).manual_seed(SEED + 5)
    c32 = torch.randn((n, d), generator=g32, device=dev)
    c32 /= c32.norm(dim=-1, keepdim=True)
    q32 = torch.randn((b, d), generator=g32, device=dev)
    q32 /= q32.norm(dim=-1, keepdim=True)
    ks, ki = scoring.flat_topk_f32_cuda(q32, c32, k, n)
    ps, pi = scoring.flat_search_plain(q32, c32, k, n)
    err = (ks - ps).abs().max().item()
    rec = recall_at_k(ki.cpu().numpy(), pi.cpu().numpy())
    if err > F32_TOL or not _ties_only(ks, ki, ps, pi, F32_TOL):
        raise RuntimeError(f"B1 f32 disagrees: max|score err| {err}, recall vs plain {rec}")
    ms = cuda_time(lambda: scoring.flat_topk_f32_cuda(q32, c32, k, n), iters=5)
    pms = cuda_time(lambda: scoring.flat_search_plain(q32, c32, k, n), iters=3)
    bms, by = roofline(n * d * 4 + b * d * 4 + b * k * 8, 2 * b * n * d, "f32")
    filt = scan_filter_stats(torch, scoring.flat_topk_f32_cuda, (q32, c32), k, n, b,
                             scoring.flat_scan_plan(b, d, n, k, torch.float32))
    log(f"B1 flat_topk_f32 1Mx768 f32 B=64 k=10: max|score err| {err:.3e} (limit {F32_TOL}), "
        f"ids vs plain {rec:.6f} (the rest near ties), kernel {ms:.4f} ms, plain (TF32 off) "
        f"{pms:.4f} ms, bound {bms:.4f} ms ({by}), {bms / ms:.1%} of it, "
        f"{filt['survivors_share']:.3%} of scores survive the filter, "
        f"{filt['merges_per_block']:.1f} merges a block")
    table["flat_topk_f32"] = {"max_abs_err": err, "ms": ms, "plain_ms": pms,
                              "bound_ms": bms, "bound_by": by, "library_ms": None,
                              "recall_at_10": rec, "shape": "1Mx768 f32 B=64 k=10", **filt}
    del c32

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
            bms, by = roofline(f * dd + f * 4 + bb * dd + bb * f * 4, 2 * bb * f * dd, "int8")
            mv[f"{name}_B{bb}"] = {"ms": t, "plain_ms": pt, "weight_GBps": gbs,
                                   "bound_ms": bms, "bound_by": by}
    g = mv["w_gateup_B1"]
    table["matvec_int8"] = {"max_abs_err": 0.0, "ms": g["ms"], "plain_ms": g["plain_ms"],
                            "bound_ms": g["bound_ms"], "bound_by": g["bound_by"],
                            "library_ms": None, "shape": "w_gateup 37888x3584 B=1",
                            "all": mv}

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
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lms = cuda_time(lambda: sdpa(qa, ka, va, is_causal=True, scale=scale,
                                 enable_gqa=True), iters=5)
    pairs = (S - 100) * (S - 99) // 2          # visible (query, key) pairs
    bms, by = roofline(2 * B * (2 * H + 2 * KH) * S * dh + B * S * 4,
                    4 * B * H * dh * pairs, "bf16")
    log(f"B6 time: kernel {ms:.4f} ms, plain {pms:.4f} ms, SDPA (is_causal, "
        f"enable_gqa) {lms:.4f} ms, bound {bms:.4f} ms ({by})")
    table["flash_prefill"] = {"max_abs_err": err, "err_over_bound": ratio, "ms": ms,
                              "plain_ms": pms, "library_ms": lms, "bound_ms": bms,
                              "bound_by": by, "shape": "B=1 S=4096 28q/4kv dh128"}
    del qa, ka, va, r

    # B5: decode attention over C=8192 at B=1 and B=8, timed with a cold L2
    C = 8192
    dec = {}
    errs = []
    for bb in (1, 8):
        qd = torch.randn((bb, H, 1, dh), generator=gen, device=dev).to(torch.bfloat16)
        km = torch.zeros((bb, C), device=dev)
        for lane in range(bb):                 # left pad per lane, half the cache unwritten
            km[lane, 37 + 97 * lane:4133] = 1
        live = km > 0
        cols = live.sum().item()                 # valid cache columns, all lanes
        copies = [tuple(torch.randn((bb, KH, C, dh), generator=gen, device=dev).to(
            torch.bfloat16) for _ in "kv") for _ in range(cold_copies(2 * KH * cols * dh * 2))]
        kc, vc = copies[0]
        o = attention.flash_decode_cuda(qd, kc, vc, km, scale)
        r = attention.attention_plain(qd, kc, vc, km, scale, causal=False)
        bound = attention.attention_error_bound(qd, kc, vc, km, scale, r, causal=False)
        diff = (o.float() - r.float()).abs()
        e, ratio = diff.max().item(), (diff / bound).max().item()
        errs.append(e)
        if ratio > 1.0 or not torch.isfinite(o).all():
            raise RuntimeError(f"B5 B={bb} disagrees: err/bound {ratio}")
        t, t_warm = timed_cold(lambda k, v: attention.flash_decode_cuda(qd, k, v, km, scale),
                               copies)
        pt = cuda_time(lambda: attention.attention_plain(qd, kc, vc, km, scale,
                                                         causal=False), iters=3)
        lt, lt_warm = timed_cold(lambda k, v: torch.nn.functional.scaled_dot_product_attention(
            qd, k, v, attn_mask=live[:, None, None, :], scale=scale, enable_gqa=True), copies)
        gbs = 2 * KH * cols * dh * 2 / (t * 1e-3) / 1e9
        bms, by = roofline(2 * KH * cols * dh * 2 + 2 * 2 * bb * H * dh + bb * C * 4,
                        4 * H * cols * dh, "bf16")
        log(f"B5 flash_decode C=8192 B={bb}: max|err| {e:.3e}, max err/bound "
            f"{ratio:.3f}, kernel {t:.4f} ms cold ({gbs:.1f} GB/s of live cache; warm "
            f"{t_warm:.4f}), plain {pt:.4f} ms, SDPA (bool mask, enable_gqa) {lt:.4f} ms "
            f"cold (warm {lt_warm:.4f}), bound {bms:.4f} ms ({by}), {bms / t:.1%} of it")
        dec[f"B{bb}"] = {"ms": t, "warm_ms": t_warm, "plain_ms": pt, "library_ms": lt,
                         "library_warm_ms": lt_warm, "max_abs_err": e,
                         "err_over_bound": ratio, "live_cache_GBps": gbs,
                         "bound_ms": bms, "bound_by": by}
        del copies, kc, vc
    d1 = dec["B1"]
    table["flash_decode"] = {"max_abs_err": max(errs), "ms": d1["ms"],
                             "plain_ms": d1["plain_ms"], "library_ms": d1["library_ms"],
                             "bound_ms": d1["bound_ms"], "bound_by": d1["bound_by"],
                             "shape": "C=8192 half live, B=1, 28q/4kv dh128, cold L2",
                             "all": dec}
    results["kernels_vs_plain"] = table
    return table


def compare_quant_kernels(torch, results: dict, table: dict) -> None:
    """Phase 3b: B2/B3 against their plain versions at 1M x 768, B=64, for
    k=10 and k=40 (the rerank depth at k=10), with each scan's filter survivors
    and merge rounds (its ``stats`` hook, one extra launch). Scores must agree within
    QUANT_REL_TOL of the largest score (bit-equal expected); ids must agree
    except where tied scores cross the k boundary."""
    from mediquery_rag_tpu_torch.obs.metrics import cuda_time, recall_at_k
    from mediquery_rag_tpu_torch.ops import quant

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    n, d, b = 1 << 20, 768, 64
    x = torch.randn((n, d), generator=gen, device=dev)
    x /= x.norm(dim=-1, keepdim=True)
    c8, s8 = quant.quantize_rows(x)
    c4, s4 = quant.quantize_rows_int4(x)
    del x
    q = torch.randn((b, d), generator=gen, device=dev)
    q8, _ = quant.quantize_rows(q / q.norm(dim=-1, keepdim=True))
    corr = (8 * q8.to(torch.int32).sum(dim=1)).float()
    cases = {
        "int8_topk": (quant.int8_topk_cuda, quant.int8_flat_search_plain,
                      (q8, c8, s8), n * d + n * 4 + b * d),
        "int4_topk": (quant.int4_topk_cuda, quant.int4_flat_search_plain,
                      (q8, corr, c4, s4), n * d // 2 + n * 4 + b * d + b * 4),
    }
    for name, (kern, plain, args, in_bytes) in cases.items():
        per_k = {}
        for k in (10, 40):
            ks, ki = kern(*args, k, n)
            ps, pi = plain(*args, k, n)
            err = (ks - ps).abs().max().item()
            rel = err / ps.abs().max().item()
            rec = recall_at_k(ki.cpu().numpy(), pi.cpu().numpy())
            rows = (ki != pi).any(dim=1)
            # a differing id set is allowed only where the k-th scores tie
            ties_only = bool((ks[rows, -1] == ps[rows, -1]).all()) and rel == 0.0
            if rel > QUANT_REL_TOL or (rec < 1.0 and not ties_only):
                raise RuntimeError(f"{name} k={k} disagrees: rel err {rel}, recall {rec}")
            ms = cuda_time(lambda: kern(*args, k, n))
            pms = cuda_time(lambda: plain(*args, k, n), iters=2, reps=3)
            bms, by = roofline(in_bytes + b * k * 8, 2 * b * n * d, "int8")
            per_k[f"k{k}"] = {"ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                              "max_abs_err": err, "rel_err": rel, "recall": rec}
            # the in-register filter: the share of scores that passed it, and
            # the merge rounds of the survivors' slots per block
            plan = (quant.int8_scan_plan(b, d, n, k) if name == "int8_topk"
                    else quant.int4_scan_plan(b, d, n // 2, k))
            filt = scan_filter_stats(torch, kern, args, k, n, b, plan)
            per_k[f"k{k}"].update(filt)
            extra = (f", {filt['survivors_share']:.3%} of scores survive the filter, "
                     f"{filt['merges_per_block']:.1f} merges a block")
            log(f"B{2 if name == 'int8_topk' else 3} {name} 1Mx768 B=64 k={k}: recall "
                f"vs plain {rec:.6f}, max|score err|/max|score| {rel:.3e}, kernel "
                f"{ms:.4f} ms, plain {pms:.4f} ms, bound {bms:.4f} ms ({by}), "
                f"{bms / ms:.1%} of it{extra}")
        k10 = per_k["k10"]
        table[name] = {"max_abs_err": k10["max_abs_err"], "ms": k10["ms"], "plain_ms": k10["plain_ms"],
                       "bound_ms": k10["bound_ms"], "bound_by": k10["bound_by"],
                       "library_ms": None, "shape": "1Mx768 B=64 k=10", "all": per_k}
    results["kernels_vs_plain"] = table


def gc_cuda(torch) -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def parity_walk(torch, models: dict, ids, mask, cache_len: int, steps: int,
                label: str) -> dict:
    """Phase 4's rule over ``models`` ("card", "cpu" in bf16, "f32" on the
    CPU): a prefill, then ``steps`` decode steps fed the f32 model's greedy
    tokens. Returns the worst relative L2 distance of the card's and the
    CPU's logits from f32's, the largest |CPU bf16 - f32| logit, at how
    many positions the card's greedy token was held to f32's (those whose
    f32 top-2 margin exceeds twice the CPU's bf16 deviation: below that,
    bf16 rounding alone may pick the runner-up), and at how many the card's
    token scored, in f32, more than twice that deviation below the f32
    maximum (``far``: a departure no near tie explains)."""
    logits, caches = {}, {}
    for name, m in models.items():
        logits[name], caches[name] = m.prefill(ids, mask, cache_len)
    worst = {"card": 0.0, "cpu": 0.0}
    checked, far, worst_noise = 0, 0, 0.0
    for step in range(steps + 1):
        lg = {name: x.float().cpu() for name, x in logits.items()}
        ref = lg["f32"]
        if not torch.isfinite(lg["card"]).all() or lg["card"].shape != ref.shape:
            raise RuntimeError(f"{label}: logits not finite or misshapen")
        rel = {name: ((lg[name] - ref).norm() / ref.norm()).item() for name in worst}
        for name in worst:
            worst[name] = max(worst[name], rel[name])
        top2 = ref.topk(2, dim=-1).values[0]
        margin = (top2[0] - top2[1]).item()
        noise = (lg["cpu"] - ref).abs().max().item()
        worst_noise = max(worst_noise, noise)
        am = {name: lg[name].argmax(-1).item() for name in lg}
        clear = margin > 2 * noise
        checked += clear
        far += ref[0, am["card"]].item() < top2[0].item() - 2 * noise
        log(f"{label} step {step}: vs f32 |dlogits|/|logits| card "
            f"{rel['card']:.3e}, cpu bf16 {rel['cpu']:.3e}; argmax card {am['card']} "
            f"cpu {am['cpu']} f32 {am['f32']}; f32 top-2 margin {margin:.3f}, "
            f"cpu bf16 max|dlogit| {noise:.3f}{'' if clear else ' (near tie)'}")
        if clear and am["card"] != am["f32"]:
            raise RuntimeError(f"{label}: greedy token differs from f32 at step {step}")
        if step == steps:
            break
        tok = ref.argmax(-1)
        logits = {name: m.decode_step(caches[name], tok) for name, m in models.items()}
    return {"card": worst["card"], "cpu": worst["cpu"], "checked": checked, "far": far,
            "noise": worst_noise}


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
    par = parity_walk(torch, models, ids, mask, 256, 15, "decoder parity")
    worst, checked, worst_noise = par, par["checked"], par["noise"]
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
                                 "greedy_checked_steps": checked,
                                 "cpu_bf16_max_logit_dev": worst_noise}


def decoder_parity_int4(torch, results: dict) -> None:
    """Phase 4b: phase 4's rule for a 2-layer 7B-width model with int4
    weights and an int8 KV cache: 4 lanes prefilled (different left pads),
    ``PARITY4B_STEPS`` ``decode_step_slots`` steps with lane 2 inactive, fed the f32
    model's greedy tokens, then one 256-token ``prefill_extend`` on lane 0.
    The card (kernels, bf16) and the CPU (plain, bf16) are each held to
    the same quantized model with f32 activations on the CPU."""
    from dataclasses import replace

    from mediquery_rag_tpu_torch.models.decoder import Decoder, init_params

    cfg = replace(qwen7b_config(layers=2), kv_dtype="int8", max_len=1024)
    params = init_params(cfg, seed=SEED, device=DEVICE, bits=4)

    def to_cpu(tree):
        return ({k: to_cpu(v) for k, v in tree.items()} if isinstance(tree, dict)
                else tree.cpu())

    cpu_params = to_cpu(params)
    models = {"card": Decoder(cfg, params), "cpu": Decoder(cfg, cpu_params),
              "f32": Decoder(replace(cfg, dtype="float32"), cpu_params)}
    gen = torch.Generator().manual_seed(SEED + 4)
    B, S, C = 4, 32, 1024
    ids = torch.randint(3, 259, (B, S), generator=gen)
    mask = torch.ones((B, S))
    for lane, pad in enumerate((0, 5, 11, 20)):
        mask[lane, :pad] = 0
    active = torch.tensor([True, True, False, True])
    logits, caches = {}, {}
    for name, m in models.items():
        logits[name], caches[name] = m.prefill(ids, mask, C)
        caches[name].cursor = torch.full((B,), S, dtype=torch.int64,
                                         device=caches[name].k.device)
    worst = {"card": 0.0, "cpu": 0.0}
    checked = 0

    def compare(lg, rows, what):
        nonlocal checked
        lg = {name: x.float().cpu().reshape(-1, cfg.vocab_size)[rows] for name, x in lg.items()}
        if not torch.isfinite(lg["card"]).all():
            raise RuntimeError(f"4b {what}: card logits not finite")
        ref = lg["f32"]
        rel = {n: ((lg[n] - ref).norm() / ref.norm()).item() for n in worst}
        for n in worst:
            worst[n] = max(worst[n], rel[n])
        top2 = ref.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        noise = (lg["cpu"] - ref).abs().amax(dim=-1)
        clear = margin > 2 * noise
        same = lg["card"].argmax(-1) == ref.argmax(-1)
        checked += int(clear.sum())
        log(f"4b {what}: vs f32 card {rel['card']:.3e}, cpu bf16 {rel['cpu']:.3e}; greedy "
            f"checked on {int(clear.sum())} of {len(rows)} lanes, equal {bool(same[clear].all())}")
        if not bool(same[clear].all()):
            raise RuntimeError(f"4b {what}: card greedy token differs from f32")

    live_rows = [b for b in range(B) if active[b]]
    for step in range(PARITY4B_STEPS + 1):
        compare(logits, list(range(B)) if step == 0 else live_rows, f"step {step}")
        if step == PARITY4B_STEPS:
            break
        tok = logits["f32"].argmax(-1)
        logits = {n: m.decode_step_slots(caches[n], tok, active) for n, m in models.items()}
    c0 = caches["card"]
    col0, pos0 = int(c0.cursor[0]), int(c0.next_pos[0])
    ext = torch.randint(3, 259, (256,), generator=gen)
    ext_mask = torch.ones(256)
    ext_logits = {}
    for n, m in models.items():
        c = caches[n]
        ext_logits[n] = m.prefill_extend(c.k[:, 0], c.v[:, 0], c.key_mask[0], ext, ext_mask,
                                         col0, pos0, k_scale_row=c.k_scale[:, 0],
                                         v_scale_row=c.v_scale[:, 0])[0]
    compare(ext_logits, [0], "prefill_extend 256 tokens")
    ratio = worst["card"] / worst["cpu"]
    log(f"4b decoder parity (int4 weights, int8 KV): worst vs f32 card {worst['card']:.3e}, "
        f"cpu bf16 {worst['cpu']:.3e}, ratio {ratio:.3f} (limit {DECODER_RATIO}); greedy "
        f"token checked {checked} times")
    if ratio > DECODER_RATIO:
        raise RuntimeError(f"int4 decoder on the card strays from the f32 reference: {ratio}")
    if checked == 0:
        raise RuntimeError("4b decoder parity: no clear greedy token")
    results["decoder_parity_int4"] = {"card_rel_err": worst["card"],
                                      "cpu_bf16_rel_err": worst["cpu"], "ratio": ratio,
                                      "greedy_checked": checked}



def serve(torch, results: dict, counters: list):
    """Phase 5: /search and /qa through the port's SearchServer."""
    from mediquery_rag_tpu_torch.config import EngineConfig
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
    llm = TorchLLMClient(gen, max_new_tokens=QA_TOKENS)
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
        for question in QUESTIONS[:1]:     # phase 5b sends more through LLMServer
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
    return gen, store


CHAT_BYTES = (300, 680, 1060, 1440, 1820, 2200, 2600, 3000)   # phase 5b prompt sizes
SHORT_PROMPTS = ["头痛怎么办？", "高血压的饮食建议", "感冒发烧吃什么药？", "BMI 如何计算？"]


def chat(port: int, body: dict, stream: bool) -> tuple[str, float, float]:
    """POST /v1/chat/completions; returns (content, seconds to the first
    content, seconds in all). A stream's deltas are concatenated."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions",
        data=json.dumps({**body, "stream": stream}).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    first = None
    with urllib.request.urlopen(req, timeout=900) as r:
        if not stream:
            content = json.loads(r.read())["choices"][0]["message"]["content"]
            t = time.perf_counter() - t0
            return content, t, t
        parts = []
        for line in r:
            line = line.decode().strip()
            if not line.startswith("data: "):
                continue
            data = line[len("data: "):]
            if data == "[DONE]":
                break
            delta = json.loads(data)["choices"][0]["delta"]
            if delta.get("content"):
                first = first or time.perf_counter() - t0
                parts.append(delta["content"])
    t = time.perf_counter() - t0
    return "".join(parts), first or t, t


def serve_llm(torch, results: dict, counters: list, store) -> dict:
    """Phase 5b: the LLM serving path as ``serve.main`` wires it
    (``build_app_server``) over phase 5's store, with the 7B-class decoder
    at int4 weights and an int8 KV cache."""
    from concurrent.futures import ThreadPoolExecutor
    from dataclasses import replace
    from types import SimpleNamespace

    from mediquery_rag_tpu_torch.llm import TorchLLMClient
    from mediquery_rag_tpu_torch.models import Generator
    from mediquery_rag_tpu_torch.models.decoder import init_params
    from mediquery_rag_tpu_torch.obs.metrics import cuda_busy
    from mediquery_rag_tpu_torch.serve import build_app_server
    from mediquery_rag_tpu_torch.serve.llm import ChatSession

    cfg = replace(qwen7b_config(), kv_dtype="int8")
    t0 = time.perf_counter()
    gen = Generator(cfg, init_params(cfg, seed=SEED, device=DEVICE, bits=4), device=DEVICE)
    wbytes = sum(t.numel() * t.element_size() for t in gen.model.buffers())
    log(f"7B-class decoder, int4 weights: {wbytes / 1e9:.3f} GB on the card, made in "
        f"{time.perf_counter() - t0:.2f} s")
    ctx = SimpleNamespace(store=store, llm=TorchLLMClient(gen, max_new_tokens=QA_TOKENS),
                          web_search=None)
    server = build_app_server(ctx)
    srv = server.llm_server
    c = srv.cache
    log(f"LLMServer: {srv.B} lanes x {srv.C} columns, int8 KV "
        f"{(c.k.nbytes + c.v.nbytes) / 1e9:.3f} GB + scales "
        f"{(c.k_scale.nbytes + c.v_scale.nbytes) / 1e6:.1f} MB, chunk {srv.T}, "
        f"prefill_chunk {srv.prefill_chunk}")
    corpus = open(os.path.join(ROOT, "data", "medical_data.txt"), encoding="utf-8").read()
    raw = corpus.encode("utf-8")
    out: dict = {}
    try:
        port = server.start("127.0.0.1", 0)
        for fn in counters:
            fn.launches = 0
        # 4 short prompts alone, then together: the same tokens whoever shares the batch
        alone = []
        for p in SHORT_PROMPTS:
            f = srv.submit(p, max_new_tokens=32)
            f.result(timeout=900)
            alone.append(f.token_ids)
        futs = [srv.submit(p, max_new_tokens=32) for p in SHORT_PROMPTS]
        for f in futs:
            f.result(timeout=900)
        together = [f.token_ids for f in futs]
        same = alone == together
        log(f"4 short prompts alone vs together: token-identical {same}, tokens "
            f"{[len(t) for t in alone]}")
        if not same:
            raise RuntimeError("batched tokens differ from the same prompts alone")
        out["batch_independent"] = same

        # 8 concurrent chat completions, 4 streamed, prompts of 300-3,000 byte tokens
        prompts = [raw[:n].decode("utf-8", errors="ignore") for n in CHAT_BYTES]
        seen, real_submit = [], srv.submit

        def recording(*a, **k):                # the HTTP handlers' futures
            f = real_submit(*a, **k)
            f.prompt = a[0]
            seen.append(f)
            return f

        srv.submit = recording
        base = dict(srv.stats)
        srv._lat_first.clear()
        srv._lat_total.clear()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            jobs = [pool.submit(chat, port, {"messages": [{"role": "user", "content": p}],
                                             "max_tokens": 64}, i % 2 == 1)
                    for i, p in enumerate(prompts)]
            replies = [j.result() for j in jobs]
        wall = time.perf_counter() - t0
        srv.submit = real_submit
        st = {k: srv.stats[k] - base[k] for k in base}
        lat = srv.latency()
        steps = st["steps"]
        tok_s = st["tokens_out"] / wall
        log(f"8 concurrent /v1/chat/completions (4 streamed) in {wall:.2f} s: "
            f"{st['tokens_out']} tokens, {tok_s:.1f} tok/s over 4 lanes, prefills "
            f"{st['prefills']}, prefill pieces {st['prefill_pieces']}, {steps} steps at "
            f"{1e3 * st['decode_s'] / max(steps, 1):.2f} ms/step; time to first token "
            f"p50 {lat['ttft_p50_s']:.3f} s, p95 {lat['ttft_p95_s']:.3f} s; request "
            f"p50 {lat['p50_s']:.3f} s, p95 {lat['p95_s']:.3f} s; reply chars "
            f"{[len(r[0]) for r in replies]}")
        if st["prefill_pieces"] <= 0:
            raise RuntimeError("no long prompt was prefilled in pieces")
        # every request decoded: tokens, or a stop at EOS (random weights
        # may emit EOS or bytes that decode to nothing first)
        done = [f for f in seen if not f.cancelled() and f.exception() is None
                and (f.token_ids or f.finish_reason == "stop")]
        log(f"  requests resolved with output: {len(done)}/{len(seen)}, tokens each "
            f"{[len(f.token_ids) for f in done]}, empty replies "
            f"{sum(not r[0] for r in replies)}")
        if len(seen) != 8 or len(done) != 8:
            raise RuntimeError(f"chat completions without output: {len(done)}/{len(seen)}")
        # phase 5c holds its speculative replies to these, prompt by prompt
        replies_by_prompt = {f.prompt: _reply_tokens(f, gen.tokenizer.eos_id) for f in seen}
        out["chat"] = {"wall_s": wall, "tokens_out": st["tokens_out"], "tok_per_s": tok_s,
                       "steps": steps, "ms_per_step": 1e3 * st["decode_s"] / max(steps, 1),
                       "prefill_pieces": st["prefill_pieces"], "latency": lat,
                       "http": [{"stream": i % 2 == 1, "first_s": r[1], "s": r[2],
                                 "chars": len(r[0]), "prompt_bytes": n}
                                for i, (r, n) in enumerate(zip(replies, CHAT_BYTES))]}

        # a 3-turn chat session: turns 2 and 3 prefill only their suffix
        before = srv.stats["extends"]
        sess = ChatSession(srv, max_new_tokens=32)
        turns = []
        for text in ("高血压患者平时饮食需要注意什么？", "每天盐吃多少合适？", "运动方面呢？"):
            t0 = time.perf_counter()
            sess.ask(text)
            turns.append(time.perf_counter() - t0)
        extends = srv.stats["extends"] - before
        log(f"3-turn ChatSession: {[round(t, 2) for t in turns]} s per turn, extends "
            f"{extends}, prefix tokens reused {srv.stats['prefix_tokens_reused']}")
        if extends < 2:
            raise RuntimeError(f"chat session extended its lane {extends} times, not 2")
        out["session"] = {"turn_s": turns, "extends": extends}

        # /qa through the server's lanes (ServedLLMClient); constrained_qa
        # runs the second, for a logged-in user
        qa = []
        for question in QUESTIONS[:1]:
            body, dt = post(port, "/qa", {"question": question})
            if not isinstance(body.get("answer"), str) or not body["answer"]:
                raise RuntimeError(f"/qa through the LLM server returned no answer: {body}")
            log(f"POST /qa through LLMServer {dt:.2f} s: answer {len(body['answer'])} "
                f"chars, {len(body['docs'])} docs")
            qa.append(dt)
        out["qa_s"] = qa
        out["constrained"] = constrained_qa(srv, server)
        if not torch.isfinite(srv.logits).all():
            raise RuntimeError("LLM server logits not finite")
        launches = {fn.__name__.removesuffix("_cuda"): fn.launches for fn in counters}
    finally:
        server.shutdown()
        srv.close()
    log(f"LLM serving path launch counts: {launches}")
    missing = [n for n in ("matvec_int4", "flash_decode_int8", "flash_prefill_int8")
               if launches[n] <= 0]
    if missing:
        raise RuntimeError(f"kernels not launched by the LLM serving path: {missing}")

    # one decode_step_slots step over the server's 4 lanes, all active
    cache = srv.cache
    act = torch.ones(srv.B, dtype=torch.bool, device=cache.k.device)
    tok = srv.logits.argmax(-1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(16):
        gen.model.decode_step_slots(cache, tok, act)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / 16
    prof = cuda_busy(lambda: gen.model.decode_step_slots(cache, tok, act), iters=16, top=64)
    ctx_cols = int(cache.key_mask.sum(1).max())
    if prof["busy_ms"] is None:
        log("decode_step_slots profile: no device records, busy time not measured")
    else:
        log(f"decode_step_slots B=4 (up to {ctx_cols} live columns): {step_ms:.2f} ms/step "
            f"unprofiled, card busy {prof['busy_ms']:.3f} ms/step "
            f"({1 - prof['busy_ms'] / step_ms:.1%} idle), {prof['device_ops']:.0f} device "
            f"ops/step")
        for name, ms, n in prof["top"][:8]:
            log(f"    {ms:8.4f} ms x {n:5.0f}  {name}")
        # B5 inside the step: its device ms per launch over the server's own caches
        b5 = [(ms, n) for name, ms, n in prof["top"] if "flash_decode_kernel" in name]
        if b5:
            per = sum(ms for ms, _ in b5) / sum(n for _, n in b5)
            results["kernels_vs_plain"]["flash_decode_int8"]["in_step_ms"] = per
            log(f"    B5 int8 + fold in the step: {per:.4f} ms per launch "
                f"({sum(n for _, n in b5):.0f} launches per step)")
        # B7 inside the step: its device ms per step and per launch
        b7 = [(ms, n) for name, ms, n in prof["top"] if "matvec_int4_kernel" in name]
        if b7:
            ms7, n7 = sum(ms for ms, _ in b7), sum(n for _, n in b7)
            results["kernels_vs_plain"]["matvec_int4"]["in_step"] = {
                "ms_per_step": ms7, "launches_per_step": n7, "busy_ms": prof["busy_ms"]}
            log(f"    B7 matvec_int4 in the step: {ms7:.3f} ms per step of the card's "
                f"{prof['busy_ms']:.3f} busy ms, {n7:.0f} launches, "
                f"{ms7 / n7:.4f} ms per launch")
    out["step"] = {"ms_per_step": step_ms, "profile": prof, "live_columns": ctx_cols}
    out["launches"] = launches
    results["llm_serving"] = out
    del srv, server, cache
    torch.cuda.empty_cache()
    return launches, gen, replies_by_prompt



def constrained_qa(srv, server) -> dict:
    """Phase 5b, grammar constraints: a /qa graph run for a logged-in user
    as the app wires it, its LLM calls through the server's lanes
    (``ServedLLMClient``), so the router's health-profile extraction
    decodes under ``EXTRACT_SCHEMA``: the reply must be JSON the schema
    accepts and no extraction error may be logged. Then a free-text and a
    ``RISK_SCHEMA`` request on one prompt, each alone in the server: host
    ms per decode step of each."""
    import logging

    import torch

    from mediquery_rag_tpu_torch.app.memory import (
        ProfileStore, extract_health_info, load_health_profile)
    from mediquery_rag_tpu_torch.graph import build_medical_graph, create_nodes
    from mediquery_rag_tpu_torch.llm.messages import user
    from mediquery_rag_tpu_torch.models.constrain import (
        EXTRACT_SCHEMA, RISK_SCHEMA, JsonConstraint)
    from mediquery_rag_tpu_torch.models.generate import (
        constraint_tables, dfa_advance, dfa_mask)
    from mediquery_rag_tpu_torch.serve.llm import ServedLLMClient

    llm = ServedLLMClient(srv, max_new_tokens=QA_TOKENS)
    replies: list = []

    class Recording:                       # keeps the extraction call's reply
        def complete(self, messages, **kw):
            out = llm.complete(messages, **kw)
            replies.append(out)
            return out

    db = os.path.join(ROOT, "build", "smoke_profiles.sqlite")
    if os.path.exists(db):
        os.remove(db)
    store = ProfileStore(db)
    errors: list = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: errors.append(record.getMessage())
    logger = logging.getLogger("mediquery_rag_tpu_torch.app.memory.health_extractor")
    logger.addHandler(handler)
    question = "我对青霉素过敏，有高血压，平时吃氨氯地平，饮食要注意什么？"
    try:
        nodes = create_nodes(llm, server.service, extract_health=lambda q, uid:
                             extract_health_info(q, uid, Recording(), store),
                             load_profile=lambda uid: load_health_profile(uid, store))
        t0 = time.perf_counter()
        events = list(build_medical_graph(nodes).stream(
            {"messages": [user(question)], "user_id": "smoke-user"}, thread_id="smoke"))
        qa_s = time.perf_counter() - t0
    finally:
        logger.removeHandler(handler)
    facts = store.get_health_records("smoke-user")
    per_step = {}
    for name, schema in (("free", None), ("constrained", RISK_SCHEMA)):
        base = dict(srv.stats)
        llm.complete(question, schema=schema)
        steps = srv.stats["steps"] - base["steps"]
        per_step[name] = (1e3 * (srv.stats["decode_s"] - base["decode_s"]) / max(steps, 1),
                          steps)
    check = JsonConstraint.compile(EXTRACT_SCHEMA, srv.tok, vocab_size=srv.gen.cfg.vocab_size)
    accepted = len(replies) == 1 and check.accepts(replies[0])
    added = per_step["constrained"][0] - per_step["free"][0]
    # the constrained step's own work, alone: the served code's DFA walk and
    # logit mask, the pick and the state update for the server's lanes under
    # RISK_SCHEMA's tables, 200 times
    risk = JsonConstraint.compile(RISK_SCHEMA, srv.tok, vocab_size=srv.gen.cfg.vocab_size)
    dev = srv.logits.device
    tables = constraint_tables([risk], dev)
    base = torch.zeros((srv.B, 1), dtype=torch.long, device=dev)
    dfa = torch.zeros(srv.B, dtype=torch.long, device=dev)
    logits = torch.randn((srv.B, srv.gen.cfg.vocab_size), device=dev)
    keep = torch.ones(srv.B, dtype=torch.bool, device=dev)

    def masked_step():
        masked, land = dfa_mask(tables, base, dfa, logits, srv.tok.eos_id)
        return dfa_advance(land, masked.argmax(-1), dfa, keep)

    masked_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        masked_step()
    torch.cuda.synchronize()
    mask_ms = 1e3 * (time.perf_counter() - t0) / 200
    log(f"logged-in /qa through LLMServer in {qa_s:.2f} s: answer "
        f"{len(events[-1][1].get('final_answer', ''))} chars; extraction reply "
        f"{(replies or [''])[0][:160]!r}, accepted by EXTRACT_SCHEMA {accepted}, health "
        f"facts stored {len(facts)}, extraction errors logged {len(errors)}; host ms per "
        f"step alone in the server: free {per_step['free'][0]:.2f} ({per_step['free'][1]} "
        f"steps), RISK_SCHEMA {per_step['constrained'][0]:.2f} "
        f"({per_step['constrained'][1]} steps): {added:+.2f} ms; the DFA walk, mask and "
        f"state update alone {mask_ms:.3f} ms per step")
    if errors or not accepted:
        raise RuntimeError(f"constrained extraction failed: errors {errors}, replies {replies}")
    return {"qa_s": qa_s, "facts": len(facts), "reply": replies[0],
            "ms_per_step": {k: v[0] for k, v in per_step.items()},
            "steps": {k: v[1] for k, v in per_step.items()}, "added_ms_per_step": added,
            "mask_ms_per_step": mask_ms}


QUANT_ROWS = 131072      # corpus + synthetic unit rows per quantized store
NEW_DOCS = [
    {"chunk_id": "live-add-1", "title": "深海鱼油与血脂调节",
     "content": "适量摄入深海鱼油可能有助于调节血脂水平，高血脂患者应在医生指导下服用鱼油制剂。",
     "tags": ["血脂", "营养"]},
    {"chunk_id": "live-add-2", "title": "儿童高热惊厥的家庭处理",
     "content": "孩子高热惊厥时应让其侧卧，保持呼吸道通畅，不要往嘴里塞东西，抽搐超过五分钟立即就医。",
     "tags": ["儿童", "发热"]},
]


def _reply_tokens(fut, eos: int) -> list[int]:
    """A finished request's token ids, with the EOS that stopped it."""
    return list(fut.token_ids) + ([eos] if fut.finish_reason == "stop" else [])


def first_divergence(torch, gen, prompt: str, a: list, b: list) -> dict | None:
    """None if the token lists agree; else where they first differ, the two
    tokens and the gap from the smaller of their two logits to the row
    maximum, from one prefill of the prompt and the shared prefix."""
    if a == b:
        return None
    j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
    if j == min(len(a), len(b)):
        return {"pos": j, "gap": float("inf"), "why": "one reply is a prefix of the other"}
    ids = gen.tokenizer.encode(prompt) + list(a[:j])
    S = -(-len(ids) // 128) * 128
    x = torch.full((1, S), gen.tokenizer.pad_id, dtype=torch.long)
    m = torch.zeros((1, S))
    x[0, S - len(ids):] = torch.tensor(ids)
    m[0, S - len(ids):] = 1.0
    logits = gen.model.prefill(x, m, S)[0][0].float()
    top = logits.max().item()
    gap = top - min(logits[a[j]].item(), logits[b[j]].item())
    return {"pos": j, "tokens": [a[j], b[j]], "gap": gap, "top": top,
            "logit_std": logits.std().item()}


def compare_ml_kernel(torch, table: dict) -> dict:
    """Phase 5c (a): B5 with the (m, l) outputs (``flash_decode_ml_cuda``)
    against ``flash_plain(return_ml=True)`` at the verify pass's shapes: G =
    5 query rows (gamma 4) per lane, B = 4 lanes, 28q/4kv, dh 128, C = 8192
    with half the columns valid, over an int8 cache and over a bf16 cache. o
    per element within ``attention_error_bound``; m within ML_M_TOL, l within
    ML_L_REL relative; the context folded with a G x G causal fresh block by
    ``extend_slots``' (o, m, l) combine per element within the bound that
    carries those errors through the combine's weights. Timed with a cold L2
    (``timed_cold``) beside B5 int8 + fold; the library column is SDPA over
    the cache (dequantized to bf16 for int8), timed the same way, which
    gives the output only, not (m, l)."""
    from mediquery_rag_tpu_torch.obs.metrics import cold_copies, cuda_time
    from mediquery_rag_tpu_torch.ops import attention

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, H, KH, dh, C, G = 4, 28, 4, 128, 8192, SPEC_GAMMA + 1
    g = H // KH
    scale = dh ** -0.5
    out, errs = {}, []
    km = torch.zeros((B, C), device=dev)
    for lane in range(B):                      # left pad per lane, half the cache unwritten
        km[lane, 37 + 97 * lane:4133] = 1
    cols = int((km > 0).sum())

    def make(kind):
        """One cache: (k, v, scales as kwargs, k and v as bf16 for SDPA)."""
        if kind == "bf16":
            k, v = (torch.randn((B, KH, C, dh), generator=gen, device=dev).to(torch.bfloat16)
                    for _ in "kv")
            return k, v, {}, k, v
        k, v = (torch.randint(-127, 128, (B, KH, C, dh), generator=gen, device=dev,
                              dtype=torch.int8) for _ in "kv")
        ks, vs = (torch.rand((B, KH, C), generator=gen, device=dev) * 0.02 + 1e-3
                  for _ in "kv")
        return (k, v, {"k_scale": ks, "v_scale": vs},
                *((c.float() * s_[..., None]).to(torch.bfloat16) for c, s_ in ((k, ks), (v, vs))))

    for kind in ("int8", "bf16"):
        q = torch.randn((B, H, G, dh), generator=gen, device=dev).to(torch.bfloat16)
        elt = 1 if kind == "int8" else 2
        nbytes = 2 * KH * cols * (dh * elt + (4 if kind == "int8" else 0))
        copies = [make(kind) for _ in range(cold_copies(nbytes))]
        k, v, sc, kd, vd = copies[0]
        o, m, l = attention.flash_decode_ml_cuda(q, k, v, km, scale, **sc)
        ro, rm, rl = attention.flash_plain(q, k, v, km, scale, return_ml=True, **sc)
        bound = attention.attention_error_bound(q, k, v, km, scale, ro, causal=False, **sc)
        ratio = ((o.float() - ro.float()).abs() / bound).max().item()
        m_err = (m - rm).abs().max().item()
        l_rel = ((l - rl).abs() / rl).max().item()
        # extend_slots' combine with a G x G causal block of fresh columns
        kn, vn = (torch.randn((B, KH, G, dh), generator=gen, device=dev) for _ in "kv")
        tri = (torch.ones(G, G, device=dev).tril() - 1.0) * 1e9

        def fold(o1, m1, l1):
            sf = (q.float() @ kn.repeat_interleave(g, 1).transpose(-1, -2)) * scale + tri
            m2 = sf.amax(-1)
            p = torch.exp(sf - m2[..., None])
            l2 = p.sum(-1)
            mm = torch.maximum(m1, m2)
            a1, e2 = torch.exp(m1 - mm) * l1, torch.exp(m2 - mm)
            ctx = ((o1.float() * a1[..., None] + (p @ vn.repeat_interleave(g, 1)) * e2[..., None])
                   / (a1 + e2 * l2)[..., None])
            return ctx, a1 / (a1 + e2 * l2), (p @ vn.repeat_interleave(g, 1)) / l2[..., None]

        ck, _, _ = fold(o, m, l)
        cp, w1, o2 = fold(ro, rm, rl)
        cbound = (w1[..., None] * bound + w1[..., None] * (1 - w1[..., None])
                  * (ML_M_TOL + ML_L_REL) * (ro.float() - o2).abs() + 1e-6 * cp.abs())
        c_ratio = ((ck - cp).abs() / cbound).max().item()
        e = (o.float() - ro.float()).abs().max().item()
        errs.append(e)
        if (ratio > 1.0 or m_err > ML_M_TOL or l_rel > ML_L_REL or c_ratio > 1.0
                or not torch.isfinite(o).all()):
            raise RuntimeError(f"B5 (m, l) {kind} disagrees: o err/bound {ratio}, m err "
                               f"{m_err}, l rel {l_rel}, folded err/bound {c_ratio}")
        t, t_warm = timed_cold(lambda k_, v_, sc_, *_: attention.flash_decode_ml_cuda(
            q, k_, v_, km, scale, **sc_), copies)
        pt = cuda_time(lambda: attention.flash_plain(q, k, v, km, scale, return_ml=True, **sc),
                       iters=3)
        lt, lt_warm = timed_cold(lambda *c: sdpa(q, c[3], c[4], scale=scale, enable_gqa=True,
                                                 attn_mask=(km > 0)[:, None, None, :]), copies)
        del copies
        bms, by = roofline(nbytes + B * C * 4 + 4 * B * H * G * dh + 8 * B * H * G,
                           4 * H * dh * G * cols, "bf16")
        log(f"B5 flash_decode (m, l) {kind} C=8192 half valid, B=4, G={G}: max|o err| {e:.3e}, "
            f"o err/bound {ratio:.3f}, m err {m_err:.2e}, l rel err {l_rel:.2e}, folded "
            f"context err/bound {c_ratio:.3f}; kernel {t:.4f} ms cold (warm {t_warm:.4f}; B5 "
            f"int8 + fold B=4, G=1: {table['flash_decode_int8']['ms']:.4f} ms), plain {pt:.4f} "
            f"ms, SDPA (output only) {lt:.4f} ms cold (warm {lt_warm:.4f}), bound {bms:.4f} ms "
            f"({by}), {bms / t:.1%} of it")
        out[kind] = {"ms": t, "warm_ms": t_warm, "plain_ms": pt, "library_ms": lt,
                     "library_warm_ms": lt_warm, "max_abs_err": e,
                     "err_over_bound": ratio, "m_err": m_err, "l_rel_err": l_rel,
                     "folded_err_over_bound": c_ratio, "bound_ms": bms, "bound_by": by}
    r = out["int8"]
    table["flash_decode_ml"] = {"max_abs_err": max(errs), **{k_: r[k_] for k_ in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        "shape": "int8 C=8192 half valid, B=4, G=5, 28q/4kv dh128", "all": out,
        "library": "SDPA over the cache dequantized to bf16: the output only, not (m, l)"}
    return out


def spec_chats(torch, label: str, store, gen, draft, nodraft: dict, tie_gap: float) -> dict:
    """Phase 5c (b, c): the 8 chat completions of 5b, 4 streamed, through an
    ``LLMServer`` with ``draft`` as ``serve.main`` wires it (``--draft``,
    ``--gamma 4``), SPEC_TOKENS tokens each. Each reply equals the first
    SPEC_TOKENS tokens of the no-draft server's reply of 5b for the same
    prompt, or departs from them first at a near tie: the two tokens'
    logits lie within ``tie_gap`` of the row maximum."""
    from concurrent.futures import ThreadPoolExecutor
    from types import SimpleNamespace

    from mediquery_rag_tpu_torch.llm import TorchLLMClient
    from mediquery_rag_tpu_torch.serve import build_app_server

    ctx = SimpleNamespace(store=store, llm=TorchLLMClient(gen, max_new_tokens=64),
                          web_search=None)
    server = build_app_server(ctx, draft=draft, gamma=SPEC_GAMMA)
    srv = server.llm_server
    raw = open(os.path.join(ROOT, "data", "medical_data.txt"), encoding="utf-8").read().encode()
    prompts = [raw[:n].decode("utf-8", errors="ignore") for n in CHAT_BYTES]
    seen, real_submit = [], srv.submit

    def recording(*a, **k):
        f = real_submit(*a, **k)
        f.prompt = a[0]
        seen.append(f)
        return f

    try:
        port = server.start("127.0.0.1", 0)
        srv.submit = recording
        base = dict(srv.stats)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            jobs = [pool.submit(chat, port, {"messages": [{"role": "user", "content": p}],
                                             "max_tokens": SPEC_TOKENS}, i % 2 == 1)
                    for i, p in enumerate(prompts)]
            for j in jobs:
                j.result()
        wall = time.perf_counter() - t0
        st = {k: srv.stats[k] - base[k] for k in base}
        lat = srv.latency()
    finally:
        server.shutdown()
        srv.close()
    if len(seen) != 8 or any(f.exception() is not None for f in seen):
        raise RuntimeError(f"{label}: {len(seen)} requests, errors "
                           f"{[f.exception() for f in seen if f.exception()]}")
    ties = {}
    for f in seen:
        d = first_divergence(torch, gen, f.prompt, nodraft[f.prompt][:SPEC_TOKENS],
                             _reply_tokens(f, gen.tokenizer.eos_id))
        if d is not None:
            ties[len(f.prompt.encode())] = d
            if not d["gap"] <= tie_gap:
                raise RuntimeError(f"{label}: a reply departs from the no-draft server's at "
                                   f"a token that is not a near tie: {d}")
    per_round = st["spec_tokens"] / max(st["spec_lane_rounds"], 1)
    rec = {"wall_s": wall, "tokens_out": st["tokens_out"], "tok_per_s": st["tokens_out"] / wall,
           "tok_per_s_per_lane": st["tokens_out"] / wall / srv.B,
           "spec_rounds": st["spec_rounds"], "spec_lane_rounds": st["spec_lane_rounds"],
           "spec_tokens": st["spec_tokens"], "tokens_per_lane_round": per_round,
           "host_ms_per_round": 1e3 * st["spec_s"] / max(st["spec_rounds"], 1),
           # host forward passes (G draft extends + one verify) per token a lane emits
           "passes_per_token": (SPEC_GAMMA + 2) / per_round,
           "draft_syncs": st["draft_syncs"], "prefill_pieces": st["prefill_pieces"],
           "quanta": st["chunks"], "latency": lat, "departures": ties}
    log(f"{label}: 8 chats in {wall:.2f} s, {st['tokens_out']} tokens, "
        f"{rec['tok_per_s']:.1f} tok/s over 4 lanes ({rec['tok_per_s_per_lane']:.2f} per lane); "
        f"{st['spec_rounds']} rounds ({st['spec_lane_rounds']} lane rounds), "
        f"{per_round:.3f} tokens per lane round ({rec['passes_per_token']:.2f} host forward "
        f"passes per token; no draft: 1), {rec['host_ms_per_round']:.1f} host ms per "
        f"round, draft syncs {st['draft_syncs']}, prefill pieces {st['prefill_pieces']}; "
        f"TTFT p50 {lat['ttft_p50_s']:.2f} s; replies departing from the no-draft server's "
        f"(all near ties) {len(ties)}/8: {ties}")
    return rec


def serve_spec(torch, results: dict, counters: list, store, gen, nodraft: dict,
               table: dict) -> dict:
    """Phase 5c: speculative serving over 5b's 28-layer int4 + int8-KV target.
    (a) B5 (m, l) against plain (those launches not counted); (b) the target
    as its own draft: at least 4.0 tokens per lane round at gamma 4 (every
    proposal the target's own, but for near ties of the two rounding paths);
    (c) a 2-layer draft at the target's widths distilled with
    ``distill_draft`` on the target's greedy continuations of the 8 chat
    prompts, saved, loaded int4 through ``serve.server.load_draft`` (as
    ``serve.main --draft DIR --draft-quantize 4`` does) and served. Every
    reply obeys the near-tie rule against 5b's no-draft replies, with phase
    4's bound: twice the largest bf16 logit deviation from f32 that phase 4
    measures at these widths (below it, bf16 rounding alone may pick the
    runner-up; the verify pass and the decode step are two bf16 forwards
    whose rounding differs)."""
    from mediquery_rag_tpu_torch.models.distill import distill_draft
    from mediquery_rag_tpu_torch.serve.server import load_draft

    out = {"ml_kernel": compare_ml_kernel(torch, table)}
    tie_gap = 2 * results["decoder_parity"]["cpu_bf16_max_logit_dev"]
    out["tie_gap"] = tie_gap
    log(f"5c near-tie bound: {tie_gap:.3f} (twice phase 4's largest bf16 logit deviation)")
    for fn in counters:
        fn.launches = 0
    out["draft_is_target"] = spec_chats(torch, "5c (b) draft = target", store, gen, gen,
                                        nodraft, tie_gap)
    b_launches = {fn.__name__.removesuffix("_cuda"): fn.launches for fn in counters}
    if out["draft_is_target"]["tokens_per_lane_round"] < 4.0:
        raise RuntimeError("draft = target: fewer than 4.0 tokens per lane round")
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    draft = distill_draft(gen, qwen7b_config(layers=2), sorted(nodraft, key=len),
                          max_new_tokens=64,
                          epochs=DISTILL_EPOCHS, seed=SEED, device=DEVICE)
    torch.cuda.synchronize()
    distill_s = time.perf_counter() - t0
    path = os.path.join(ROOT, "build", "chip_smoke_draft")
    draft.save(path)
    loss = draft.last_loss
    del draft
    torch.cuda.empty_cache()
    log(f"5c (c) distilled a 2-layer draft at the 7B widths, {DISTILL_EPOCHS} epochs over the "
        f"target's greedy continuations of the 8 chat prompts: {distill_s:.2f} s, last loss "
        f"{loss:.4f}")
    loaded = load_draft(path, quantize=4, device=DEVICE)
    rec = spec_chats(torch, "5c (c) distilled int4 draft", store, gen, loaded, nodraft, tie_gap)
    c_launches = {fn.__name__.removesuffix("_cuda"): fn.launches for fn in counters}
    rec.update({"distill_s": distill_s, "distill_loss": loss, "launches": c_launches})
    out["distilled"] = rec
    out["draft_is_target"]["launches"] = b_launches
    log(f"5c launch counts: (b) {b_launches}; (c) {c_launches}")
    need = {"(b)": (b_launches, ("flash_decode_ml", "matvec_int4", "flash_prefill")),
            "(c)": (c_launches, ("flash_decode_ml", "flash_prefill", "matvec_int4",
                                 "flash_dq", "flash_dkv"))}
    missing = [(part, n) for part, (got, names) in need.items() for n in names if got[n] <= 0]
    if missing:
        raise RuntimeError(f"kernels not launched by the speculative path: {missing}")
    results["speculative"] = out
    return {n: b_launches[n] + c_launches[n] for n in b_launches}


def store_rows():
    """The rows of phases 6 and 6b: the corpus chunks (IDF lexical vectors)
    plus synthetic unit rows from SEED, 131,072 rows at 3,072 dims, and
    their documents. Returns (chunks, embedder, vectors, documents)."""
    import numpy as np

    from mediquery_rag_tpu_torch.ingest import Chunk, parse_corpus_file
    from mediquery_rag_tpu_torch.ingest.pipeline import _embed_chunks
    from mediquery_rag_tpu_torch.models import IDFHashingEmbedder

    chunks = parse_corpus_file(os.path.join(ROOT, "data", "medical_data.txt"))
    emb = IDFHashingEmbedder.fit_chunks(chunks)
    t0 = time.perf_counter()
    real = _embed_chunks(emb, chunks, 64)
    rng = np.random.default_rng(SEED)
    syn = rng.standard_normal((QUANT_ROWS - len(chunks), real.shape[1]), dtype=np.float32)
    syn /= np.linalg.norm(syn, axis=1, keepdims=True)
    vecs = np.concatenate([real, syn])
    del syn
    # synthetic rows have no text: they are placeholder documents
    docs = chunks + [Chunk(chunk_id=f"syn-{i:06d}", title="", content="",
                           source="synthetic") for i in range(QUANT_ROWS - len(chunks))]
    log(f"store rows: {vecs.shape[0]} rows x {vecs.shape[1]} made in "
        f"{time.perf_counter() - t0:.2f} s")
    return chunks, emb, vecs, docs


def serve_quantized(torch, results: dict, counters: list, rows) -> dict:
    """Phase 6: the quantized retrieval path. An int8 store and an int4
    store with rerank_factor=4 hold ``store_rows()``; each is served over
    HTTP and held to the same store built on the CPU."""
    from mediquery_rag_tpu_torch.config import EngineConfig
    from mediquery_rag_tpu_torch.engine.flat import FlatIndex
    from mediquery_rag_tpu_torch.ingest import DocumentStore
    from mediquery_rag_tpu_torch.llm.client import FakeLLM
    from mediquery_rag_tpu_torch.native.rerank import native_rerank, rerank_available
    from mediquery_rag_tpu_torch.serve import build_server

    t0 = time.perf_counter()
    native = {"built": rerank_available()}      # g++ build at first use: set-up, not a request
    log(f"native rerank library (native/rerank.cpp): built {native['built']} in "
        f"{time.perf_counter() - t0:.2f} s")
    chunks, emb, vecs, docs = rows
    queries = [c.title for c in chunks] * 4
    stream_q = emb(queries[:512])
    out = {}
    for fn in counters:
        fn.launches = 0
    native_rerank.calls = 0
    for dtype, factor in (("int8", 0), ("int4", 4)):
        cfg = EngineConfig(dim=vecs.shape[1], dtype=dtype, rerank_factor=factor)
        t0 = time.perf_counter()
        store = DocumentStore(list(docs), FlatIndex.build(vecs, cfg, device=DEVICE), emb)
        ref = DocumentStore(list(docs), FlatIndex.build(vecs, cfg, device="cpu"), emb)
        ix = store.index
        log(f"{dtype} store (rerank_factor {factor}): corpus {tuple(ix.corpus.shape)} "
            f"{ix.corpus.dtype}, {ix.nbytes / 1e6:.1f} MB on the card, refine copy "
            f"{0 if ix.refine is None else ix.refine.nbytes / 1e6:.1f} MB on the host, "
            f"built (card + CPU) in {time.perf_counter() - t0:.2f} s")
        server = build_server(store, FakeLLM())
        rec = {"nbytes": ix.nbytes, "requests": []}
        try:
            port = server.start("127.0.0.1", 0)
            for question in QUESTIONS:
                body, dt = post(port, "/search", {"query": question, "k": 5})
                got = [r["metadata"]["chunk_id"] for r in body["results"][0]]
                want = [r.metadata["chunk_id"] for r in ref.similarity_search(question, k=5)]
                log(f"  POST /search {dt * 1e3:.1f} ms: top-5 {got}, CPU store {want}")
                if got != want:
                    raise RuntimeError(f"{dtype} /search top-5 differs from the CPU store")
                rec["requests"].append({"path": "/search", "s": dt})
            body, dt = post(port, "/documents", {"documents": NEW_DOCS})
            if body.get("added") != 2:
                raise RuntimeError(f"{dtype} /documents: {body}")
            log(f"  POST /documents {dt * 1e3:.1f} ms: {body}")
            rec["requests"].append({"path": "/documents", "s": dt})
            for d in NEW_DOCS:
                body, dt = post(port, "/search", {"query": d["title"] + "：" + d["content"],
                                                  "k": 5})
                top = body["results"][0][0]["metadata"]["chunk_id"]
                log(f"  POST /search for {d['chunk_id']} {dt * 1e3:.1f} ms: first {top}")
                if top != d["chunk_id"]:
                    raise RuntimeError(f"{dtype}: added {d['chunk_id']} does not rank first")
            body, dt = post(port, "/documents/delete",
                            {"chunk_ids": [d["chunk_id"] for d in NEW_DOCS] + ["absent"]})
            if body.get("deleted") != 2:
                raise RuntimeError(f"{dtype} /documents/delete: {body}")
            log(f"  POST /documents/delete {dt * 1e3:.1f} ms: {body}")
            rec["requests"].append({"path": "/documents/delete", "s": dt})
            for d in NEW_DOCS:
                body, _ = post(port, "/search", {"query": d["title"], "k": 5})
                ids = [r["metadata"]["chunk_id"] for r in body["results"][0]]
                if d["chunk_id"] in ids:
                    raise RuntimeError(f"{dtype}: deleted {d['chunk_id']} still found")
            batches = [stream_q[i:i + 64] for i in range(0, 512, 64)]
            t0 = time.perf_counter()
            streamed = list(store.index.search_stream(batches, k=10))
            t_stream = time.perf_counter() - t0
            t0 = time.perf_counter()
            single = [store.index.search(qb, k=10) for qb in batches]
            t_single = time.perf_counter() - t0
            same = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                       for a, b in zip(streamed, single))
            log(f"  search_stream 8 x 64 (k=10) {t_stream * 1e3:.1f} ms vs search "
                f"{t_single * 1e3:.1f} ms, bit-identical {same}")
            if not same:
                raise RuntimeError(f"{dtype}: search_stream differs from search")
            rec.update(stream_s=t_stream, search_s=t_single)
        finally:
            server.shutdown()
        out[dtype] = rec
        del store, ref, ix
    launches = {fn.__name__.removesuffix("_cuda"): fn.launches for fn in counters}
    native["calls"] = native_rerank.calls
    log(f"quantized path launch counts: {launches}; native rerank library built "
        f"{native['built']}, calls by the int4 store's rerank {native['calls']}")
    for name in ("int8_topk", "int4_topk"):
        if launches[name] <= 0:
            raise RuntimeError(f"{name} not launched by the quantized path")
    if native["built"] and native["calls"] <= 0:
        raise RuntimeError("the native rerank built but the int4 rerank did not use it")
    results["quantized"] = {"stores": out, "native_rerank": native, "launches": launches}
    return launches


IVF_ROWS, IVF_CENTERS, IVF_NOISE = 1 << 20, 4096, 0.3   # phase 3c: clustered unit rows
EQUAL_ROWS, EQUAL_CHUNK = 196608, 65536   # phase 6c (a): all rows in the k-means sample
# phase 6c (c): (rows, chunk rows) of each StreamingFlatIndex; 4M int8 rows stand in,
# cut for the run's time, for a corpus beyond the card's 80 GB
STREAM_FLAT = {"int8": (4 << 20, 1 << 20), "bfloat16": (1 << 20, 1 << 18)}


def _row_ties_only(ks, ki, ps, pi, tol: float) -> bool:
    """One top-k row of kernel and plain (lists) agrees but for near ties:
    an id that only one side returns scores within ``tol`` of the other
    side's k-th score."""
    a, b = set(ki), set(pi)
    for j in range(len(ki)):
        if ki[j] not in b and ks[j] < ps[-1] - tol:
            return False
        if pi[j] not in a and ps[j] > ks[-1] + tol:
            return False
    return True


def _ties_only(ks, ki, ps, pi, tol: float) -> bool:
    """``_row_ties_only`` for every row of ``[B, k]`` tensors."""
    ks, ki, ps, pi = (t.cpu().tolist() for t in (ks, ki, ps, pi))
    return all(_row_ties_only(*row, tol) for row in zip(ks, ki, ps, pi))


def _ivf_calls(torch, ix, q, pid, k: int, batch: bool):
    """(kernel call, plain call) of the index's bucket-major (``batch``) or
    query-major kernel on its own tensors: queries ``q`` f32 on the card,
    probe ids ``pid``."""
    from mediquery_rag_tpu_torch.ops import ivf_kernel as ik
    from mediquery_rag_tpu_torch.ops.quant import quantize_rows

    bk, ids, sc = ix.buckets, ix.bucket_ids, ix.bucket_scales
    uniq = ik.unique_probes(pid, ix.nlist)       # read by the plain versions only
    kw = {"extent": ix.extent}                   # the Hopper IVF scans read the live extent
    if ix.cfg.dtype == "int4":
        q8, corr, _ = ik.int4_query(q)
        if batch:
            return (lambda: ik.ivf_batch_topk_int4_cuda(pid, uniq, q8, corr, bk, ids, sc, k,
                                                        **kw),
                    lambda: ik.ivf_batch_search_int4_plain(pid, uniq, q8, corr, bk, ids, sc, k))
        return (lambda: ik.ivf_probe_topk_int4_cuda(pid, q8, corr, bk, ids, sc, k, **kw),
                lambda: ik.ivf_probe_search_int4_plain(pid, q8, corr, bk, ids, sc, k))
    int8 = sc is not None
    f32 = bk.dtype == torch.float32
    qk = quantize_rows(q)[0] if int8 else q.to(bk.dtype)
    scl = [sc] if int8 else []
    if batch:
        kern = (ik.ivf_batch_topk_int8_cuda if int8 else
                ik.ivf_batch_topk_f32_cuda if f32 else ik.ivf_batch_topk_cuda)
        return (lambda: kern(pid, uniq, qk, bk, ids, *scl, k, **kw),
                lambda: ik.ivf_batch_search_plain(pid, uniq, qk, bk, ids, sc, k))
    kern = (ik.ivf_probe_topk_int8_cuda if int8 else
            ik.ivf_probe_topk_f32_cuda if f32 else ik.ivf_probe_topk_cuda)
    plain = ik.ivf_probe_search_int8_plain if int8 else ik.ivf_probe_search_plain
    return (lambda: kern(pid, qk, bk, ids, *scl, k, **kw),
            lambda: plain(pid, qk, bk, ids, *scl, k))


def _ivf_agree(torch, kern_out, plain_out, exact: bool,
               tol: float = TOPK_TOL) -> tuple[bool, float]:
    """int8/int4 (``exact``): scores and ids bit-equal; bf16 and f32:
    scores within ``tol`` (TOPK_TOL, F32_TOL) and ids equal but for near
    ties. Returns (agree, max |score error|)."""
    (ks, ki), (ps, pi) = kern_out, plain_out
    fin = torch.isfinite(ps)
    same_inf = torch.equal(torch.isinf(ks), torch.isinf(ps))
    err = (ks - ps)[fin].abs().max().item() if bool(fin.any()) else 0.0
    if exact:
        return torch.equal(ks, ps) and torch.equal(ki, pi), err
    return same_inf and err <= tol and _ties_only(ks, ki, ps, pi, tol), err


def ivf_rows(torch):
    """Phase 3c's rows, made again from the seed wherever needed: 1M x 768
    clustered unit rows on the card, 256 held-out queries from the same
    mixture and the exact f32 top-10 of each. Returns (x, queries, exact)."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    centers = torch.randn((IVF_CENTERS, 768), generator=gen, device=dev)
    x = centers[torch.randint(0, IVF_CENTERS, (IVF_ROWS,), generator=gen, device=dev)]
    x += IVF_NOISE * torch.randn((IVF_ROWS, 768), generator=gen, device=dev)
    x /= x.norm(dim=1, keepdim=True)
    q = centers[torch.randint(0, IVF_CENTERS, (256,), generator=gen, device=dev)]
    q = q + IVF_NOISE * torch.randn((256, 768), generator=gen, device=dev)
    q /= q.norm(dim=1, keepdim=True)
    exact = torch.topk(q @ x.T, 10, dim=1).indices.cpu().numpy()
    return x, q, exact


def int4_deep_recall(ix, q, exact, nprobe: int) -> float:
    """recall@10 of an int4 IVF index whose host rerank takes 12k = 120
    candidates (``rerank_factor=12``) instead of its own depth."""
    from dataclasses import replace

    from mediquery_rag_tpu_torch.obs.metrics import recall_at_k

    deep = replace(ix, cfg=replace(ix.cfg, rerank_factor=12))
    rec = recall_at_k(deep.search(q, k=10, nprobe=nprobe)[1].numpy(), exact)
    log(f"IVF int4 recall@10 at nprobe {nprobe} with the rerank over 120 candidates "
        f"(rerank_factor 12): {rec:.4f}")
    return rec


def f32_add_delete(torch, ix, q) -> dict:
    """Phase 3c, the f32 IVF index on the card: ``add`` 5 held-out queries
    as new rows (each must then be its own nearest row at nprobe 32) and
    ``delete`` them again (none may be found)."""
    t0 = time.perf_counter()
    grown = ix.add(q[:5])
    add_s = time.perf_counter() - t0
    _, got = grown.search(q[:5], k=1, nprobe=32)
    new_ids = list(range(ix.next_id, ix.next_id + 5))
    t0 = time.perf_counter()
    shrunk = grown.delete(new_ids)
    del_s = time.perf_counter() - t0
    _, after = shrunk.search(q[:5], k=10, nprobe=32)
    found = got[:, 0].tolist()
    gone = not bool(torch.isin(after, torch.tensor(new_ids, dtype=after.dtype)).any())
    log(f"IVF f32 add 5 rows {add_s * 1e3:.1f} ms: nearest ids {found} (new {new_ids}); "
        f"delete {del_s * 1e3:.1f} ms: none found after {gone}")
    if found != new_ids or not gone:
        raise RuntimeError(f"IVF f32 add/delete: found {found}, deleted gone {gone}")
    return {"add_s": add_s, "delete_s": del_s}


def compare_ivf_kernels(torch, results: dict, table: dict) -> dict:
    """Phase 3c: IVF builds at 1M x 768 and B8a/B8b/B8c/B9a/B9b/B9c against
    their plain versions, B8a/B9a over bf16 and over f32 buckets (the f32
    index also adds and deletes rows). int8 and int4 must be bit-equal;
    bf16 within TOPK_TOL and f32 within F32_TOL, ids equal but for near
    ties. Both layouts compute one
    function, held to one bound: the larger of the bytes it must move (the
    live rows (int4: the packed rows holding a live slot) and scales of each
    distinct probed bucket once, the ids of its slots, the queries, probe
    ids and results) over 3.35 TB/s and the multiply-adds the kernel does
    for every probing (query, live row) pair (int4: two products per packed
    row) over the peak of their type."""
    from mediquery_rag_tpu_torch.config import EngineConfig
    from mediquery_rag_tpu_torch.engine import FlatIndex, IVFIndex
    from mediquery_rag_tpu_torch.obs.metrics import cuda_time, recall_at_k
    from mediquery_rag_tpu_torch.ops import ivf_kernel as ik
    from mediquery_rag_tpu_torch.ops.topk import exact_topk

    d, nprobe = 768, 32
    x, qall, exact = ivf_rows(torch)
    out: dict = {"builds": {}}
    idx = {}
    # int8 and int4 as they serve: with the exact host rerank of 4k candidates
    for name, kw in (("bf16", {"dtype": "bfloat16"}), ("bf16_again", {"dtype": "bfloat16"}),
                     ("f32", {"dtype": "float32"}),
                     ("int8", {"dtype": "int8", "rerank_factor": 4}),
                     ("int4", {"dtype": "int4", "rerank_factor": 4})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ix = IVFIndex.build(x, EngineConfig(dim=d, **kw), device=DEVICE)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        log(f"IVF build {name} 1Mx768 nlist {ix.nlist}: {dt:.2f} s, cap {ix.cap}, "
            f"{ix.nbytes / 1e9:.3f} GB on the card")
        out["builds"][name] = {"s": dt, "cap": ix.cap, "nbytes": ix.nbytes}
        idx[name] = ix
    # flat int4 (B3) at the served rerank on the same rows: what int4 + rerank
    # reaches here without the probe, the yardstick of the int4 IVF store
    flat4 = FlatIndex.build(x, EngineConfig(dim=d, dtype="int4", rerank_factor=4),
                            device=DEVICE)
    again = idx.pop("bf16_again")
    same = (torch.equal(again.bucket_ids, idx["bf16"].bucket_ids)
            and torch.equal(again.centroids, idx["bf16"].centroids))
    log(f"IVF bf16 built twice from one seed: bucket ids and centroids equal {same}")
    if not same:
        raise RuntimeError("two IVF builds from one seed differ")
    del again, x

    out["recall_at_10"] = {}
    for name, ix in idx.items():
        _, got = ix.search(qall, k=10, nprobe=nprobe)
        rec = recall_at_k(got.numpy(), exact)
        log(f"IVF {name} recall@10 at nprobe {nprobe} vs the exact f32 scan, {len(exact)} "
            f"held-out queries: {rec:.4f}")
        out["recall_at_10"][name] = rec
        if name == "int4":
            # int4's step (max|x| / 7) is coarse against the score gaps inside
            # these tight clusters: 4k candidates keep few of the true top-10
            # (flat int4 as well), so the served rerank_factor=4 is held within
            # 0.02 of flat int4's and the 0.9 floor at 12k = 120 candidates
            flat_rec = recall_at_k(flat4.search(qall, k=10)[1].numpy(), exact)
            log(f"flat int4 (B3) rerank_factor 4 recall@10 on the same rows: {flat_rec:.4f}; "
                f"IVF int4 minus flat int4 {rec - flat_rec:+.4f}")
            out["recall_at_10"]["flat_int4"] = flat_rec
            if abs(rec - flat_rec) > 0.02:
                raise RuntimeError(f"IVF int4 recall@10 {rec} not within 0.02 of flat int4's "
                                   f"{flat_rec}")
            rec = int4_deep_recall(ix, qall, exact, nprobe)
            out["recall_at_10"]["int4_rerank12"] = rec
            del flat4
        if rec < 0.9:
            raise RuntimeError(f"IVF {name} recall@10 {rec} < 0.9")
        if name == "f32":
            out["f32_add_delete"] = f32_add_delete(torch, ix, qall)

    def setup(name, bq, k):
        """(kernel call, plain call, bytes, operations, type) at B=bq."""
        quant = name.rsplit("_", 1)[-1] if name.endswith(("int8", "int4", "f32")) else "bf16"
        ix = idx[quant]
        q = qall[:bq]
        pid = exact_topk(q @ ix.centroids.T, nprobe)[1].to(torch.int32).contiguous()
        call, plain = _ivf_calls(torch, ix, q, pid, k, "batch" in name)
        live_slot = ix.bucket_ids >= 0
        live = live_slot.sum(dim=1)                      # live slots per bucket
        if quant == "int4":
            h = ix.cap // 2                              # a packed row holds slots r, r + h
            rows = (live_slot[:, :h] | live_slot[:, h:]).sum(dim=1)
            row_bytes, scale_bytes, q_bytes, products = d, 4, d + 4, 2
        else:
            rows = live
            row_bytes, scale_bytes, q_bytes, products = {
                "int8": (d, 4, d, 1), "f32": (4 * d, 0, 4 * d, 1)}.get(quant, (2 * d, 0, 2 * d, 1))
        uniq = ik.unique_probes(pid, ix.nlist)
        uniq = uniq[uniq >= 0].long()
        nbytes = (int(rows[uniq].sum()) * row_bytes + int(live[uniq].sum()) * scale_bytes
                  + uniq.numel() * ix.cap * 4 + bq * q_bytes + bq * nprobe * 4 + bq * k * 8)
        ops = 2 * d * products * int(rows[pid.long()].sum())
        return call, plain, nbytes, ops, {"bf16": "bf16", "f32": "f32"}.get(quant, "int8")

    names = {"ivf_probe_topk": "B8a", "ivf_probe_topk_f32": "B8a f32",
             "ivf_probe_topk_int8": "B8b", "ivf_probe_topk_int4": "B8c",
             "ivf_batch_topk": "B9a", "ivf_batch_topk_f32": "B9a f32",
             "ivf_batch_topk_int8": "B9b", "ivf_batch_topk_int4": "B9c"}
    for name, tag in names.items():
        per = {}
        for bq in (1, 64):
            for k in (10, 20, 40):
                call, plain, nbytes, ops, kind = setup(name, bq, k)
                kout, pout = call(), plain()
                torch.cuda.synchronize()
                ok, err = _ivf_agree(torch, kout, pout, kind == "int8",
                                     F32_TOL if kind == "f32" else TOPK_TOL)
                rec = recall_at_k(kout[1].cpu().numpy(), pout[1].cpu().numpy())
                if not ok:
                    raise RuntimeError(f"{tag} {name} B={bq} k={k} disagrees: err {err}, "
                                       f"recall vs plain {rec}")
                ms = cuda_time(call)
                pms = cuda_time(plain, iters=2, reps=3)
                bms, by = roofline(nbytes, ops, kind)
                log(f"{tag} {name} B={bq} k={k}: max|score err| {err:.3e}, ids vs plain "
                    f"{rec:.4f}, kernel {ms:.4f} ms, plain {pms:.4f} ms, bound {bms:.4f} ms "
                    f"({by}: {nbytes / 1e9:.4f} GB, {ops / 1e9:.3f} G ops), {bms / ms:.1%} of it")
                per[f"B{bq}_k{k}"] = {"ms": ms, "plain_ms": pms, "bound_ms": bms,
                                      "bound_by": by, "max_abs_err": err, "recall": rec,
                                      "bytes": nbytes, "ops": ops}
        h = per["B64_k10"]
        cap = idx[name.rsplit("_", 1)[-1] if name.endswith(("int8", "int4", "f32"))
                  else "bf16"].cap
        table[name] = {**{key: h[key] for key in ("max_abs_err", "ms", "plain_ms",
                                                  "bound_ms", "bound_by")},
                       "library_ms": None,
                       "shape": f"1Mx768 nlist 1024 nprobe 32 cap {cap} B=64 k=10",
                       "all": per}

    # the layout crossover on this card, kernels alone, beside the batch from
    # which IVFIndex.search takes the bucket-major layout (its rule, set from
    # this table: ops.ivf_kernel.ivf_layout_threshold)
    cross = {}
    for suffix in ("", "_f32", "_int8", "_int4"):
        kind = suffix[1:] or "bf16"
        wins = []
        for bq in (1, 8, 16, 32, 64, 256):
            pm = cuda_time(setup("ivf_probe_topk" + suffix, bq, 10)[0])
            bm = cuda_time(setup("ivf_batch_topk" + suffix, bq, 10)[0])
            cross[f"{kind}_B{bq}"] = {"query_major_ms": pm, "bucket_major_ms": bm}
            log(f"IVF layouts {kind} B={bq} k=10: query-major {pm:.4f} ms, "
                f"bucket-major {bm:.4f} ms")
            if bm < pm:
                wins.append(bq)
        rule = ik.ivf_layout_threshold(kind, nprobe, idx[kind].nlist)
        cross[f"{kind}_rule_from"] = rule
        log(f"IVF layouts {kind}: bucket-major faster at B={wins}; IVFIndex.search takes it "
            f"from B={rule}")
    out["crossover"] = cross
    results["ivf_kernels"] = out
    return {name: idx[name] for name in ("bf16", "int8", "int4")}


SHARDS = 4               # phase 11: shards sharing the one card
SHARD_SMALL = 3000       # phase 11: a corpus that leaves whole shards without a valid row


def _same_lists(torch, label: str, got, want) -> None:
    """Sharded (scores, ids) equal to the single-card scan's bit for bit, or
    an error naming the elements that differ and why."""
    (gs, gi), (ws, wi) = (tuple(t.cpu() for t in got), tuple(t.cpu() for t in want))
    if torch.equal(gs, ws) and torch.equal(gi, wi):
        return
    bad = ((gs != ws) | (gi != wi)).nonzero().tolist()
    where = [{"query": r, "rank": c, "sharded": (gs[r, c].item(), int(gi[r, c])),
              "single": (ws[r, c].item(), int(wi[r, c])),
              "why": ("an equal score, its ids in another order" if gs[r, c] == ws[r, c]
                      else "another score")} for r, c in bad[:8]]
    raise RuntimeError(f"{label}: {len(bad)} elements differ from the single-card scan: "
                       f"{where}")


def sharded_retrieval(torch, results: dict, ivf_idx: dict, card: str) -> dict:
    """Phase 11 (run after 3c, over its IVF indexes and its rows made again
    from the seed): the sharded indexes with SHARDS shards that share the
    card (``corpus_mesh(4, devices=[cuda:0] * 4)``; the launch helper's
    device switch cannot show on one card). (a) ``ShardedFlatIndex`` bf16,
    f32, int8 and int4 over the 1M x 768 rows at B = 1 and 64, k = 10:
    scores and ids bit-equal to ``FlatIndex``'s scan (no rerank), the
    ``slice_mesh(2, 2)`` index equal to the ``corpus_mesh(4)`` one, and a
    3,000-row corpus whose last shards hold no valid row equal to its own
    ``FlatIndex``; (b) ``ShardedIVFIndex.from_single`` over 3c's bf16, int8
    and int4 indexes (nlist 1,024, nprobe 32) at B = 1 and 64 in both
    layouts bit-equal to ``IVFIndex.search``'s kernel output, and a batch of
    64 whose every probe lies on shard 0; (c) an int4 flat and an int8 IVF
    index saved on 4 shards, loaded onto ``corpus_mesh(1)`` and searched
    equal; (d) a trace of one sharded search (``obs.capture_trace`` and
    ``obs.span``) that holds the span's name and the scan kernel's launches; (e)
    every sharded search launches its kernel once per shard (counters set
    to 0 just before, read just after), and CUDA-event times of the sharded
    and the single-card search (results copied to the host) at B = 64.
    Returns the kernels' launches on the sharded path."""
    import shutil
    from dataclasses import replace

    from mediquery_rag_tpu_torch.config import EngineConfig
    from mediquery_rag_tpu_torch.engine import FlatIndex, ShardedFlatIndex, ShardedIVFIndex
    from mediquery_rag_tpu_torch.engine import checkpoint
    from mediquery_rag_tpu_torch.obs import capture_trace, span
    from mediquery_rag_tpu_torch.obs.metrics import cuda_time
    from mediquery_rag_tpu_torch.ops import ivf_kernel as ik
    from mediquery_rag_tpu_torch.ops import quant, scoring
    from mediquery_rag_tpu_torch.parallel import corpus_mesh, slice_mesh

    dev = torch.device(DEVICE)
    mesh = corpus_mesh(SHARDS, devices=[dev] * SHARDS)
    sliced_mesh = slice_mesh(2, SHARDS // 2, devices=[dev] * SHARDS)
    one_mesh = corpus_mesh(1, devices=[dev])
    x, qall, _ = ivf_rows(torch)
    launches: dict = collections.Counter()
    out: dict = {"flat": {}, "ivf": {}, "shards": SHARDS}
    work = os.path.join(ROOT, "build", "p11_work")
    shutil.rmtree(work, ignore_errors=True)

    def host(idx, q, **kw):
        return tuple(t.cpu() for t in idx.search(q, k=10, **kw))

    def counted(kern, label, fn):
        kern.launches = 0
        res = fn()
        torch.cuda.synchronize()
        n = kern.launches
        launches[kern.__name__.removesuffix("_cuda")] += n
        if n != SHARDS:
            raise RuntimeError(f"{label}: {n} launches of {kern.__name__}, want {SHARDS}")
        return res

    flat_kern = {"bfloat16": scoring.flat_topk_cuda, "float32": scoring.flat_topk_f32_cuda,
                 "int8": quant.int8_topk_cuda, "int4": quant.int4_topk_cuda}
    traced = None
    for dtype, kern in flat_kern.items():
        cfg = EngineConfig(dim=768, dtype=dtype)
        single = FlatIndex.build(x, cfg, device=DEVICE)
        sharded = ShardedFlatIndex.build(x, mesh, cfg)
        sliced = ShardedFlatIndex.build(x, sliced_mesh, replace(cfg, dcn_axis="dcn"))
        small = ShardedFlatIndex.build(x[:SHARD_SMALL], mesh, cfg)
        small_single = FlatIndex.build(x[:SHARD_SMALL], cfg, device=DEVICE)
        empty = sum(s * small.per_shard >= SHARD_SMALL for s in range(SHARDS))
        if not empty:
            raise RuntimeError(f"11a {dtype}: the {SHARD_SMALL}-row corpus fills every shard")
        for b in (1, 64):
            q = qall[:b]
            label = f"11a sharded flat {dtype} B={b}"
            got = counted(kern, label, lambda: host(sharded, q))
            _same_lists(torch, label, got, single.search(q, k=10))
            _same_lists(torch, label + " slice_mesh(2, 2)", host(sliced, q), got)
            _same_lists(torch, label + f" {SHARD_SMALL} rows ({empty} empty shards)",
                        counted(kern, label + " small", lambda: host(small, q)),
                        small_single.search(q, k=10))
        q = qall[:64]
        ms = cuda_time(lambda: host(sharded, q), iters=5)
        ms1 = cuda_time(lambda: single.search(q, k=10), iters=5)
        out["flat"][dtype] = {"per_shard": sharded.per_shard, "tile": sharded.cfg.corpus_tile,
                              "nbytes": sharded.nbytes, "sharded_ms": ms, "single_ms": ms1,
                              "small_empty_shards": empty}
        log(f"11a sharded flat {dtype} 1Mx768 over {SHARDS} shards of {sharded.per_shard} rows "
            f"on one card: B=1/64 k=10 bit-equal to FlatIndex, slice_mesh(2, 2) equal, "
            f"{SHARD_SMALL} rows ({empty} shards without a valid row) equal; search B=64 "
            f"{ms:.4f} ms sharded vs {ms1:.4f} ms single-card (results on the host)  [{card}]")
        if dtype == "int4":
            path = os.path.join(work, "flat_int4")
            t0 = time.perf_counter()
            checkpoint.save_sharded_index(sharded, path)
            t1 = time.perf_counter()
            loaded = checkpoint.load_sharded_index(path, one_mesh)
            t2 = time.perf_counter()
            _same_lists(torch, "11c flat int4 saved on 4 shards, loaded on 1",
                        host(loaded, q), host(sharded, q))
            out["checkpoint_flat_int4"] = {"save_s": t1 - t0, "load_s": t2 - t1}
            log(f"11c flat int4 saved on {SHARDS} shards in {t1 - t0:.2f} s, loaded onto "
                f"corpus_mesh(1) in {t2 - t1:.2f} s: search equal")
            del loaded
        if dtype == "bfloat16":
            traced = sharded
        del single, sharded, sliced, small, small_single
        torch.cuda.empty_cache()

    # (d) a trace of one sharded search
    trace_dir = os.path.join(work, "trace")
    q = qall[:64]
    with capture_trace(trace_dir):
        with span("mediquery.sharded_search"):
            host(traced, q)
    files = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events]
    scans = [n for n, e in zip(names, events) if e.get("cat") == "kernel" and "scan_kernel" in n]
    out["trace"] = {"label": "mediquery.sharded_search" in names, "scan_kernels": len(scans),
                    "events": len(events)}
    log(f"11d trace of one 4-shard bf16 search: {len(events)} events, label present "
        f"{out['trace']['label']}, {len(scans)} scan kernel launches "
        f"({scans[0] if scans else 'none'})")
    if not out["trace"]["label"] or len(scans) != SHARDS:
        raise RuntimeError(f"11d: the trace lacks the label or the {SHARDS} scan launches: "
                           f"{out['trace']}")
    del traced, x

    kinds = {"bf16": ("", ""), "int8": ("_int8", "_int8"), "int4": ("_int4", "_int4")}
    for name, (pq, bq) in kinds.items():
        ix = replace(ivf_idx[name], refine=None)          # the kernels' output, no rerank
        sh = ShardedIVFIndex.from_single(ix, mesh)
        probe = getattr(ik, f"ivf_probe_topk{pq}_cuda")
        batch = getattr(ik, f"ivf_batch_topk{bq}_cuda")
        for b in (1, 64):
            q = qall[:b]
            for batched, kern in ((False, probe), (True, batch)):
                label = f"11b sharded IVF {name} B={b} batched={batched}"
                got = counted(kern, label, lambda: host(sh, q, nprobe=32, batched=batched))
                _same_lists(torch, label, got, ix.search(q, k=10, nprobe=32, batched=batched))
        cents = sh.centroids[:64]
        qs = cents + 0.002 * torch.randn(cents.shape, generator=torch.Generator(
            device=dev).manual_seed(SEED + 11), device=dev)
        qs = qs / qs.norm(dim=1, keepdim=True)
        pid = (qs @ sh.centroids.T).argmax(dim=1)
        if int(pid.max()) >= sh.per_shard:
            raise RuntimeError(f"11b {name}: the skewed batch probes past shard 0: {pid}")
        for batched, kern in ((False, probe), (True, batch)):
            label = f"11b sharded IVF {name} all probes on shard 0 batched={batched}"
            got = counted(kern, label, lambda: host(sh, qs, nprobe=1, batched=batched))
            _same_lists(torch, label, got, ix.search(qs, k=10, nprobe=1, batched=batched))
        q = qall[:64]
        ms = cuda_time(lambda: host(sh, q, nprobe=32), iters=5)
        ms1 = cuda_time(lambda: ix.search(q, k=10, nprobe=32), iters=5)
        out["ivf"][name] = {"per_shard": sh.per_shard, "nbytes": sh.nbytes,
                            "sharded_ms": ms, "single_ms": ms1}
        log(f"11b sharded IVF {name} nlist {sh.nlist} over {SHARDS} shards of {sh.per_shard} "
            f"clusters + a sentinel: B=1/64 k=10 nprobe 32, both layouts, bit-equal to "
            f"IVFIndex.search; 64 queries all probing shard 0 (nprobe 1) equal; search B=64 "
            f"(the card's layout rule) {ms:.4f} ms sharded vs {ms1:.4f} ms single-card  "
            f"[{card}]")
        if name == "int8":
            path = os.path.join(work, "ivf_int8")
            checkpoint.save_sharded_ivf(sh, path)
            loaded = checkpoint.load_sharded_ivf(path, one_mesh)
            for batched in (False, True):
                _same_lists(torch, f"11c IVF int8 saved on 4 shards, loaded on 1 "
                            f"batched={batched}", host(loaded, q, nprobe=32, batched=batched),
                            host(sh, q, nprobe=32, batched=batched))
            log("11c IVF int8 saved on 4 shards, loaded onto corpus_mesh(1): search equal in "
                "both layouts")
            del loaded
        del sh, ix
    shutil.rmtree(work, ignore_errors=True)
    out["launches"] = dict(launches)
    log(f"11e sharded-path launches (each search: one per shard): {dict(launches)}")
    results["sharded"] = out
    return dict(launches)


def compare_llm_kernels(torch, results: dict, table: dict) -> None:
    """Phase 3d: the kernels of the LLM serving path against their plain
    versions at its shapes. B7 must be bit-equal at every 7B projection and
    row count, and is timed cold (``obs.cuda_time_cold``); B5/B6 over an int8 cache
    are held per element to ``attention_error_bound`` with the int8 scales
    (the bf16 rounding of p*vs). Beside each attention kernel, SDPA over
    the same cache dequantized to bf16 (the fresh column appended for B5);
    B5 and its SDPA yardstick timed with a cold L2 (``timed_cold``)."""
    from mediquery_rag_tpu_torch.obs.metrics import cold_copies, cuda_time, cuda_time_cold
    from mediquery_rag_tpu_torch.ops import attention, matvec

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    # B7: int4 matvec at every 7B-class projection (in, out), at 1 and the 4 slot
    # lanes, 8, 20 (the 4 lanes' speculative verify pass, gamma 4) and 128 rows (a
    # short prefill); cold: rotating over copies of the packed weights and scales
    # whose bytes pass twice the L2 between two uses of one, as 28 layers do
    shapes = {"qkv": (3584, 4608), "attn_out": (3584, 3584), "w_gate": (3584, 18944),
              "w_up": (3584, 18944), "w_down": (18944, 3584), "lm_head": (3584, 384)}
    rows_timed = (1, 4, 8, 20, 128)
    mv = {}
    for name, (dd, f) in shapes.items():
        wbytes = f // 2 * dd + f * 4
        copies = [(torch.randint(-128, 128, (f // 2, dd), generator=gen, device=dev,
                                 dtype=torch.int8),
                   torch.rand((2, f // 2), generator=gen, device=dev) * 1e-3)
                  for _ in range(cold_copies(wbytes))]
        for bb in rows_timed:
            x8 = torch.randint(-127, 128, (bb, dd), generator=gen, device=dev,
                               dtype=torch.int8)
            corr = 8.0 * x8.to(torch.int32).sum(dim=-1, keepdim=True).float()
            q4, s2 = copies[0]
            out = matvec.matvec_int4_cuda(x8, corr, q4, s2)
            ref = matvec.int4_matmul_plain(x8, corr, q4, s2)
            if not torch.equal(out, ref):
                raise RuntimeError(f"B7 {name} B={bb} not bit-equal: "
                                   f"{(out - ref).abs().max().item()}")
            t = cuda_time_cold([lambda c=c: matvec.matvec_int4_cuda(x8, corr, *c)
                                for c in copies])
            bms, by = roofline(wbytes + bb * dd + bb * 4 + bb * f * 4, 2 * bb * f * dd, "int8")
            rec = {"ms": t, "bound_ms": bms, "bound_by": by, "copies": len(copies)}
            if bb == 4:
                rec["plain_ms"] = cuda_time(lambda: matvec.int4_matmul_plain(x8, corr, q4, s2),
                                            iters=3)
            log(f"B7 matvec_int4 {name} F={f} D={dd} B={bb}: bit-equal, kernel {t:.4f} ms "
                f"cold ({wbytes / (t * 1e-3) / 1e9:.1f} GB/s of packed weights and scales), "
                f"bound {bms:.4f} ms ({by}), {bms / t:.1%} of it"
                + (f", plain {rec['plain_ms']:.4f} ms" if "plain_ms" in rec else ""))
            mv[f"{name}_B{bb}"] = rec
        del copies
        torch.cuda.empty_cache()
    step = {bb: sum(mv[f"{n}_B{bb}"]["ms"] for n in shapes if n != "lm_head") * 28
            + mv[f"lm_head_B{bb}"]["ms"] for bb in rows_timed}
    log("B7 summed over one 28-layer decode step (141 launches), cold: "
        + ", ".join(f"{step[bb]:.3f} ms at B={bb}" for bb in rows_timed))
    g = mv["w_gate_B4"]
    table["matvec_int4"] = {"max_abs_err": 0.0, **{k: g[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by")}, "library_ms": None,
        "shape": "w_gate 18944x3584 B=4, cold", "all": mv, "step_ms": step}

    # B5 over an int8 cache with the fresh-column fold, C=8192 half valid
    H, KH, dh, C = 28, 4, 128, 8192
    scale = dh ** -0.5
    dec, errs = {}, []

    def cache(bb, n):
        k8, v8 = (torch.randint(-127, 128, (bb, KH, n, dh), generator=gen, device=dev,
                                dtype=torch.int8) for _ in "kv")
        ks, vs = (torch.rand((bb, KH, n), generator=gen, device=dev) * 0.02 + 1e-3
                  for _ in "kv")
        return k8, v8, ks, vs

    def dequant(c8, sc):
        return (c8.float() * sc[..., None]).to(torch.bfloat16)

    for bb in (1, 4):
        q = torch.randn((bb, H, 1, dh), generator=gen, device=dev).to(torch.bfloat16)
        km = torch.zeros((bb, C), device=dev)
        for lane in range(bb):                 # left pad per lane, half the cache unwritten
            km[lane, 37 + 97 * lane:4133] = 1
        cols = int((km > 0).sum())
        copies = [cache(bb, C) for _ in range(cold_copies(2 * KH * cols * (dh + 4)))]
        k8, v8, ks, vs = copies[0]
        fresh = {"fresh_k": torch.randn((bb, KH, 1, dh), generator=gen, device=dev).to(torch.bfloat16),
                 "fresh_v": torch.randn((bb, KH, 1, dh), generator=gen, device=dev).to(torch.bfloat16),
                 "fresh_gate": torch.ones(bb, device=dev)}
        if bb > 1:
            fresh["fresh_gate"][2] = 0.0           # one inactive lane
        args = (q, k8, v8, ks, vs, km, scale)
        o = attention.flash_decode_int8_cuda(*args, **fresh)
        r = attention.flash_plain(q, k8, v8, km, scale, k_scale=ks, v_scale=vs, **fresh)
        bound = attention.attention_error_bound(q, k8, v8, km, scale, r, causal=False,
                                                k_scale=ks, v_scale=vs, **fresh)
        diff = (o.float() - r.float()).abs()
        e, ratio = diff.max().item(), (diff / bound).max().item()
        errs.append(e)
        if ratio > 1.0 or not torch.isfinite(o).all():
            raise RuntimeError(f"B5 int8+fold B={bb} disagrees: err/bound {ratio}")
        t, t_warm = timed_cold(lambda k8_, v8_, ks_, vs_: attention.flash_decode_int8_cuda(
            q, k8_, v8_, ks_, vs_, km, scale, **fresh), copies)
        pt = cuda_time(lambda: attention.flash_plain(q, k8, v8, km, scale, k_scale=ks,
                                                     v_scale=vs, **fresh), iters=3)
        deq = [(torch.cat([dequant(c[0], c[2]), fresh["fresh_k"]], dim=2),
                torch.cat([dequant(c[1], c[3]), fresh["fresh_v"]], dim=2)) for c in copies]
        live = torch.cat([km > 0, (fresh["fresh_gate"] > 0)[:, None]], dim=1)
        lt, lt_warm = timed_cold(lambda kd, vd: sdpa(q, kd, vd, attn_mask=live[:, None, None, :],
                                                     scale=scale, enable_gqa=True), deq)
        bms, by = roofline(2 * KH * cols * (dh + 4) + bb * C * 4 + 4 * bb * H * dh
                           + 4 * bb * KH * dh + bb * 4, 4 * H * dh * (cols + bb), "bf16")
        log(f"B5 flash_decode_int8 + fold C=8192 B={bb}: max|err| {e:.3e}, max err/bound "
            f"{ratio:.3f}, kernel {t:.4f} ms cold (warm {t_warm:.4f}), plain {pt:.4f} ms, "
            f"SDPA over the cache dequantized to bf16 {lt:.4f} ms cold (warm {lt_warm:.4f}), "
            f"bound {bms:.4f} ms ({by}), {bms / t:.1%} of it")
        dec[f"B{bb}"] = {"ms": t, "warm_ms": t_warm, "plain_ms": pt, "library_ms": lt,
                         "library_warm_ms": lt_warm, "max_abs_err": e,
                         "err_over_bound": ratio, "bound_ms": bms, "bound_by": by}
        del copies, deq, k8, v8, ks, vs
    d4 = dec["B4"]
    table["flash_decode_int8"] = {"max_abs_err": max(errs), **{k: d4[k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        "shape": "int8 C=8192 half valid, fresh fold, B=4 28q/4kv dh128, cold L2", "all": dec,
        "library": "SDPA over the cache dequantized to bf16, fresh column appended"}

    # B6 over an int8 cache: a 256-token piece at column 2048 of an 8192-column cache
    S, col0 = 256, 2048
    q = torch.randn((1, H, S, dh), generator=gen, device=dev).to(torch.bfloat16)
    k8, v8, ks, vs = cache(1, C)
    km = torch.zeros((1, C), device=dev)
    km[:, 11:col0 + S] = 1
    off = torch.tensor([col0], dtype=torch.int32, device=dev)
    args = (q, k8, v8, ks, vs, km, off, scale)
    o = attention.flash_prefill_int8_cuda(*args)
    r = attention.flash_plain(q, k8, v8, km, scale, causal=True, q_offset=off,
                              k_scale=ks, v_scale=vs)
    bound = attention.attention_error_bound(q, k8, v8, km, scale, r, causal=True,
                                            q_offset=off, k_scale=ks, v_scale=vs)
    diff = (o.float() - r.float()).abs()
    e, ratio = diff.max().item(), (diff / bound).max().item()
    del bound, diff
    if ratio > 1.0 or not torch.isfinite(o).all():
        raise RuntimeError(f"B6 int8 disagrees: err/bound {ratio}")
    t = cuda_time(lambda: attention.flash_prefill_int8_cuda(*args))
    pt = cuda_time(lambda: attention.flash_plain(q, k8, v8, km, scale, causal=True,
                                                 q_offset=off, k_scale=ks, v_scale=vs), iters=2)
    kd, vd = dequant(k8, ks), dequant(v8, vs)
    vis = attention._visible(km, S, C, True, off)
    lt = cuda_time(lambda: sdpa(q, kd, vd, attn_mask=vis, scale=scale, enable_gqa=True))
    ncols = col0 + S - 11
    pairs = sum(col0 + rr + 1 - 11 for rr in range(S))
    bms, by = roofline(2 * KH * ncols * (dh + 4) + 4 * H * S * dh + C * 4 + 4,
                       4 * H * dh * pairs, "bf16")
    log(f"B6 flash_prefill_int8 S=256 at col0 2048, C=8192: max|err| {e:.3e}, max err/bound "
        f"{ratio:.3f}, kernel {t:.4f} ms, plain {pt:.4f} ms, SDPA over the cache dequantized "
        f"to bf16 {lt:.4f} ms, bound {bms:.4f} ms ({by}), {bms / t:.1%} of it")
    table["flash_prefill_int8"] = {"max_abs_err": e, "err_over_bound": ratio, "ms": t,
                                   "plain_ms": pt, "library_ms": lt, "bound_ms": bms,
                                   "bound_by": by, "shape": "int8 B=1 S=256 col0 2048 C=8192",
                                   "library": "SDPA over the cache dequantized to bf16"}
    results["kernels_vs_plain"] = table



def check_store_kernels(torch, ix, emb, texts, counters: list) -> dict:
    """Phase 6b, before serving: B8a/B9a (bf16 store), B8b/B9b (int8 store)
    or B8c/B9c (int4 store) on the store's own index tensors at B=1 and
    B=64, k=5 and k=20 (the rerank depth at k=5), against their plain
    versions. These launches compare kernels; the counters are put back as
    they were."""
    from mediquery_rag_tpu_torch.engine.flat import l2_normalize
    from mediquery_rag_tpu_torch.ops.topk import exact_topk

    saved = [fn.launches for fn in counters]
    exact = ix.bucket_scales is not None           # int8 and int4: bit-equal
    # f32 buckets: the f32 sum bound D 2^-24 on unit rows (F32_TOL's rule at this D)
    tol = ix.buckets.shape[1] * 2.0 ** -24 if ix.buckets.dtype == torch.float32 else TOPK_TOL
    q = l2_normalize(torch.as_tensor(emb(texts), dtype=torch.float32, device=DEVICE))
    nprobe = min(ix.cfg.ivf_nprobe, ix.nlist)
    pid = exact_topk(q @ ix.centroids.T, nprobe)[1].to(torch.int32).contiguous()
    out = {}
    for bq in (1, 64):
        for k in (5, 20):
            for batch in (False, True):
                call, plain = _ivf_calls(torch, ix, q[:bq].contiguous(),
                                         pid[:bq].contiguous(), k, batch)
                ok, err = _ivf_agree(torch, call(), plain(), exact, tol)
                tag = f"{'batch' if batch else 'probe'}_B{bq}_k{k}"
                out[tag] = err
                if not ok:
                    raise RuntimeError(f"IVF store kernel {tag} disagrees with plain: err {err}")
    for fn, n in zip(counters, saved):
        fn.launches = n
    log(f"  store's index, kernels vs plain at B=1/64, k=5/20, both layouts: agree "
        f"({'bit-equal' if exact else f'within {tol:.3g}'}), max|score err| "
        f"{max(out.values()):.3e}")
    return out


def serve_ivf(torch, results: dict, counters: list, rows) -> dict:
    """Phase 6b: the IVF retrieval path over HTTP. f32 and bf16 IVF stores
    and int8 and int4 IVF stores with rerank_factor=4 over ``store_rows()``;
    each card index is saved and loaded on the CPU as the reference store,
    so the check does not depend on the build."""
    from mediquery_rag_tpu_torch.config import EngineConfig
    from mediquery_rag_tpu_torch.engine import IVFIndex
    from mediquery_rag_tpu_torch.ingest import DocumentStore
    from mediquery_rag_tpu_torch.llm.client import FakeLLM
    from mediquery_rag_tpu_torch.ops.ivf_kernel import ivf_layout_threshold
    from mediquery_rag_tpu_torch.serve import build_server

    chunks, emb, vecs, docs = rows
    out = {}
    for fn in counters:
        fn.launches = 0
    for dtype, factor in (("float32", 0), ("bfloat16", 0), ("int8", 4), ("int4", 4)):
        cfg = EngineConfig(dim=vecs.shape[1], dtype=dtype, rerank_factor=factor)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ix = IVFIndex.build(vecs, cfg, device=DEVICE)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        path = os.path.join(ROOT, "build", f"chip_smoke_ivf_{dtype}")
        ix.save(path)
        ref = DocumentStore(list(docs), IVFIndex.load(path, device="cpu"), emb)
        store = DocumentStore(list(docs), ix, emb)
        seen: list[int] = []
        inner = store.batch_search

        def recording(queries, k=5, where=None, _inner=inner, _seen=seen):
            _seen.append(len(queries))
            return _inner(queries, k, where=where)

        store.batch_search = recording           # the server binds it at build
        log(f"IVF {dtype} store (rerank_factor {factor}): nlist {ix.nlist}, cap {ix.cap}, "
            f"{ix.nbytes / 1e6:.1f} MB on the card, built in {build_s:.2f} s")
        # a burst the card's layout rule sends to the bucket-major kernel
        kind = {"float32": "f32", "bfloat16": "bf16"}.get(dtype, dtype)
        n_q = max(64, ivf_layout_threshold(kind, min(ix.cfg.ivf_nprobe, ix.nlist), ix.nlist))
        if n_q > len(chunks):
            raise RuntimeError(f"IVF {dtype}: the layout rule needs {n_q} queries, the corpus "
                               f"has {len(chunks)} titles")
        batch_q = [c.title for c in chunks[:n_q]]
        rec = {"build_s": build_s, "cap": ix.cap, "nbytes": ix.nbytes, "requests": [],
               "burst_queries": n_q,
               "kernels_vs_plain": check_store_kernels(torch, ix, emb, batch_q, counters)}
        server = build_server(store, FakeLLM())
        try:
            port = server.start("127.0.0.1", 0)
            for question in QUESTIONS:
                body, dt = post(port, "/search", {"query": question, "k": 5})
                got = [r["metadata"]["chunk_id"] for r in body["results"][0]]
                want = [r.metadata["chunk_id"] for r in ref.similarity_search(question, k=5)]
                log(f"  POST /search {dt * 1e3:.1f} ms: top-5 {got}, CPU store {want}")
                if got != want:
                    raise RuntimeError(f"IVF {dtype} /search top-5 differs from the CPU store")
                rec["requests"].append({"path": "/search", "s": dt})
            want = [[(r.metadata["chunk_id"], r.score) for r in row]
                    for row in ref.batch_search(batch_q, k=5)]
            sfx = "" if kind == "bf16" else "_" + kind
            bm = next(fn for fn in counters if fn.__name__ == f"ivf_batch_topk{sfx}_cuda")
            bm_before = bm.launches
            for _ in range(3):                   # the batcher may split a burst
                body, dt = post(port, "/search", {"queries": batch_q, "k": 5})
                if max(seen) >= n_q:
                    break
            got = [[(r["metadata"]["chunk_id"], r["score"]) for r in row]
                   for row in body["results"]]
            top5 = sum([c for c, _ in g] == [c for c, _ in w] for g, w in zip(got, want))
            # top-5 equal to the CPU store but for scores tied within TOPK_TOL
            agree = sum(len(g) == len(w) == 5
                        and all(abs(gs - ws) <= TOPK_TOL for (_, gs), (_, ws) in zip(g, w))
                        and _row_ties_only([gs for _, gs in g], [c for c, _ in g],
                                           [ws for _, ws in w], [c for c, _ in w], TOPK_TOL)
                        for g, w in zip(got, want))
            log(f"  POST /search, {n_q} queries {dt * 1e3:.1f} ms: batch sizes the store saw "
                f"{seen}; top-5 equal to the CPU store {top5}/{n_q}, equal but for near ties "
                f"{agree}/{n_q}; {bm.__name__} launched {bm.launches - bm_before} times")
            if agree != n_q or max(seen) < n_q or bm.launches == bm_before:
                raise RuntimeError(f"IVF {dtype} {n_q}-query /search: top-5 agrees on "
                                   f"{agree}/{n_q}, batches {seen}, bucket-major launches "
                                   f"{bm.launches - bm_before}")
            rec["requests"].append({"path": f"/search x{n_q}", "s": dt, "batches": list(seen)})
            body, dt = post(port, "/qa", {"question": QUESTIONS[0]})
            if not isinstance(body.get("answer"), str) or not isinstance(body.get("docs"), list):
                raise RuntimeError(f"IVF {dtype} /qa: {body}")
            log(f"  POST /qa {dt * 1e3:.1f} ms: {len(body['docs'])} docs")
            rec["requests"].append({"path": "/qa", "s": dt})
            body, dt = post(port, "/documents", {"documents": NEW_DOCS})
            if body.get("added") != 2:
                raise RuntimeError(f"IVF {dtype} /documents: {body}")
            log(f"  POST /documents {dt * 1e3:.1f} ms: {body}")
            rec["requests"].append({"path": "/documents", "s": dt})
            for doc in NEW_DOCS:
                body, dt = post(port, "/search", {"query": doc["title"] + "：" + doc["content"],
                                                  "k": 5})
                top = body["results"][0][0]["metadata"]["chunk_id"]
                log(f"  POST /search for {doc['chunk_id']} {dt * 1e3:.1f} ms: first {top}")
                if top != doc["chunk_id"]:
                    raise RuntimeError(f"IVF {dtype}: added {doc['chunk_id']} does not rank first")
            body, dt = post(port, "/documents/delete",
                            {"chunk_ids": [doc["chunk_id"] for doc in NEW_DOCS] + ["absent"]})
            if body.get("deleted") != 2:
                raise RuntimeError(f"IVF {dtype} /documents/delete: {body}")
            log(f"  POST /documents/delete {dt * 1e3:.1f} ms: {body}")
            rec["requests"].append({"path": "/documents/delete", "s": dt})
            for doc in NEW_DOCS:
                body, _ = post(port, "/search", {"query": doc["title"], "k": 5})
                if doc["chunk_id"] in [r["metadata"]["chunk_id"] for r in body["results"][0]]:
                    raise RuntimeError(f"IVF {dtype}: deleted {doc['chunk_id']} still found")
        finally:
            server.shutdown()
        out[dtype] = rec
        del store, ref, ix
    launches = {fn.__name__.removesuffix("_cuda"): fn.launches for fn in counters}
    log(f"IVF path launch counts: {launches}")
    ivf_names = ("ivf_probe_topk", "ivf_probe_topk_f32", "ivf_probe_topk_int8",
                 "ivf_probe_topk_int4", "ivf_batch_topk", "ivf_batch_topk_f32",
                 "ivf_batch_topk_int8", "ivf_batch_topk_int4")
    missing = [name for name in ivf_names if launches[name] <= 0]
    if missing:
        raise RuntimeError(f"IVF kernels not launched by the IVF path: {missing}")
    results["ivf_serving"] = {"stores": out, "launches": launches}
    return launches


def host_link(torch) -> dict:
    """The host link as ``nvidia-smi`` reports it and the measured rate of
    one pinned 1 GiB host-to-card copy (median of 3, CUDA events)."""
    link = subprocess.run(
        ["nvidia-smi", "--query-gpu=pcie.link.gen.current,pcie.link.width.current",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60).stdout.strip()
    host = torch.empty(1 << 30, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(1 << 30, dtype=torch.uint8, device=DEVICE)
    card.copy_(host, non_blocking=True)
    torch.cuda.synchronize()
    ms = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        card.copy_(host, non_blocking=True)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    ms = sorted(ms)[1]
    rate = (1 << 30) / (ms * 1e-3)
    log(f"host link (nvidia-smi gen, width): {link}; one pinned 1 GiB copy to the card "
        f"{ms:.3f} ms, {rate / 1e9:.2f} GB/s")
    return {"nvidia_smi": link, "copy_ms": ms, "bytes_per_s": rate}


def _search_s(torch, index, q, prefetch: bool, reps: int = 3) -> float:
    """Median host seconds of ``index.search(q, k=10)`` (it returns host
    tensors, so the card is done when it returns)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index.search(q, k=10, prefetch=prefetch)
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def streaming_tiers(torch, results: dict, counters: list) -> dict:
    """Phase 6c: the streaming tiers. (a) ``IVFIndex.build_streaming`` at
    196,608 of phase 3c's rows (all in the k-means sample) in 65,536-row
    host chunks, bf16, int8 and int4, each held bucket for bucket to
    ``build`` from the same seed; (b) ``build_streaming`` of all 1M x 768
    rows at int4 with its timings, and recall@10 (the host refine copy set,
    as the in-memory index keeps it; the rerank over 40 and over 120
    candidates) within 0.01 of phase 3c's in-memory int4 index; (c)
    ``StreamingFlatIndex`` int8 over 4M x 768 rows (3.2 GB
    of host RAM in four 2^20-row chunks; a cut of a corpus beyond 80 GB)
    and bf16 over 1M rows, each searched at B=64, k=10 and held to a
    resident ``FlatIndex`` on the card (int8: the same rows, built from the
    first chunk and grown by ``add``; bf16: an f32 index over the same
    bf16-rounded rows, and the plain f32 product over them), timed with and
    without prefetch against the host link's measured rate. The references
    run first; the launch counters are reset just before and read just after
    each streaming search, which must launch its scan kernel once per chunk
    and nothing else."""
    from dataclasses import replace

    from mediquery_rag_tpu_torch.config import EngineConfig
    from mediquery_rag_tpu_torch.engine import FlatIndex, IVFIndex, StreamingFlatIndex
    from mediquery_rag_tpu_torch.engine.flat import l2_normalize
    from mediquery_rag_tpu_torch.obs.metrics import recall_at_k
    from mediquery_rag_tpu_torch.ops.scoring import flat_search_plain

    dev = torch.device(DEVICE)
    out: dict = {"equal_builds": {}}
    x, qall, exact = ivf_rows(torch)
    n, d = x.shape

    # (a) streamed == in memory, bucket for bucket
    part = x[:EQUAL_ROWS].cpu().numpy()
    for dtype in ("bfloat16", "int8", "int4"):
        cfg = EngineConfig(dim=d, dtype=dtype)
        t0 = time.perf_counter()
        mem = IVFIndex.build(part, cfg, seed=SEED, device=DEVICE)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        st = IVFIndex.build_streaming(
            lambda: (part[i:i + EQUAL_CHUNK] for i in range(0, EQUAL_ROWS, EQUAL_CHUNK)),
            EQUAL_ROWS, cfg, seed=SEED, chunk_rows=EQUAL_CHUNK, device=DEVICE)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rows = mem.buckets.shape[0]
        same = (st.cap == mem.cap and torch.equal(st.centroids, mem.centroids)
                and torch.equal(st.bucket_ids, mem.bucket_ids)
                and torch.equal(st.buckets[:rows], mem.buckets)
                and (mem.bucket_scales is None
                     or torch.equal(st.bucket_scales, mem.bucket_scales)))
        log(f"build_streaming {dtype} {EQUAL_ROWS:,} x {d} in chunks of {EQUAL_CHUNK:,}: "
            f"{t2 - t1:.2f} s (in memory "
            f"{t1 - t0:.2f} s), cap {st.cap}; centroids, bucket ids, buckets and scales "
            f"equal to build's: {same}")
        if not same:
            raise RuntimeError(f"build_streaming {dtype} differs from build")
        out["equal_builds"][dtype] = {"stream_s": t2 - t1, "build_s": t1 - t0, "cap": st.cap}
        del mem, st
    del part

    # (b) 1M x 768 int4, streamed from host chunks
    refine = l2_normalize(x).half().cpu().numpy()   # the in-memory build's refine copy
    host = x.cpu().numpy()
    del x
    tm: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = IVFIndex.build_streaming(lambda: (host[i:i + 65536] for i in range(0, n, 65536)), n,
                                  EngineConfig(dim=d, dtype="int4", rerank_factor=4),
                                  seed=SEED, chunk_rows=65536, timings=tm, device=DEVICE)
    nchunks = -(-n // 65536)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    del host
    st_plain = replace(st, refine=None)
    st.refine = refine
    rec4 = recall_at_k(st.search(qall, k=10, nprobe=32)[1].numpy(), exact)
    rec_scan = recall_at_k(st_plain.search(qall, k=10, nprobe=32)[1].numpy(), exact)
    rec = int4_deep_recall(st, qall, exact, 32)
    ref = results["ivf_kernels"]["recall_at_10"]
    log(f"build_streaming int4 {n:,} x {d} in {nchunks} chunks: {build_s:.2f} s, cap {st.cap}, "
        f"{st.nbytes / 1e9:.3f} GB on the card (dummy tail included); timings {tm}; recall@10 "
        f"with the rerank over 120 candidates {rec:.4f} (in memory, phase 3c: "
        f"{ref['int4_rerank12']:.4f}), over 40 {rec4:.4f} (in memory {ref['int4']:.4f}), "
        f"scan alone {rec_scan:.4f}")
    if (abs(rec - ref["int4_rerank12"]) > 0.01 or rec < 0.9
            or abs(rec4 - ref["int4"]) > 0.01):
        raise RuntimeError(f"streamed int4 IVF recall {rec} (40 candidates {rec4}) vs "
                           f"in-memory {ref['int4_rerank12']} ({ref['int4']})")
    out["streamed_int4_1M"] = {"build_s": build_s, "timings": tm, "recall_at_10": rec,
                               "recall_at_10_rerank4": rec4, "recall_at_10_scan": rec_scan,
                               "in_memory_recall_at_10": ref["int4_rerank12"]}
    del st, st_plain, refine, qall

    # (c) the host-streaming flat index
    link = host_link(torch)
    out["link"] = link
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    q = torch.randn((64, d), generator=gen, device=dev)
    tiers = {}
    for dtype, (rows, chunk_rows) in STREAM_FLAT.items():
        cfg = EngineConfig(dim=d, dtype=dtype, corpus_tile=2048)
        seed = SEED + (7 if dtype == "int8" else 8)

        def blocks():
            g = torch.Generator(device=dev).manual_seed(seed)
            for _ in range(rows // chunk_rows):
                yield torch.randn((chunk_rows, d), generator=g, device=dev).cpu().numpy()

        t0 = time.perf_counter()
        st = StreamingFlatIndex.build_from_blocks(blocks(), cfg, chunk_rows=chunk_rows,
                                                  device=DEVICE)
        build_s = time.perf_counter() - t0
        if dtype == "int8":                  # the same rows, resident: built, then grown
            g = torch.Generator(device=dev).manual_seed(seed)
            res, qr = None, q
            for _ in range(rows // chunk_rows):
                xr = torch.randn((chunk_rows, d), generator=g, device=dev)
                res = FlatIndex.build(xr, cfg, device=DEVICE) if res is None else res.add(xr)
            del xr
        else:                                # f32 over the streamed bf16-rounded rows
            xr = torch.cat(st.chunks)[:rows].to(dev).float()
            res = FlatIndex.build(xr, replace(cfg, dtype="float32", metric="dot"),
                                  device=DEVICE)
            qr = l2_normalize(q)
        # the references first, outside the counted window
        rs, ri = res.search(qr, k=10)
        if dtype != "int8":                  # and the plain f32 product (no kernel)
            ps, pi = (t.cpu() for t in flat_search_plain(qr, xr, 10, rows))
            del xr
        for fn in counters:
            fn.launches = 0
        s, i = st.search(q, k=10)
        launches = {fn.__name__.removesuffix("_cuda"): fn.launches for fn in counters}
        own = "int8_topk" if dtype == "int8" else "flat_topk_f32"
        stray = {name: c for name, c in launches.items() if c and name != own}
        if launches[own] != len(st.chunks) or stray:
            raise RuntimeError(f"streaming {dtype} search launched {launches}, expected "
                               f"{own} once for each of its {len(st.chunks)} chunks")
        err = (s - rs).abs().max().item()
        if dtype == "int8":
            ok = torch.equal(s, rs) and _ties_only(s, i, rs, ri, 0.0)
            plain_err = None
        else:
            plain_err = (s - ps).abs().max().item()
            ok = (err <= F32_TOL and _ties_only(s, i, rs, ri, F32_TOL)
                  and plain_err <= F32_TOL and _ties_only(s, i, ps, pi, F32_TOL))
        ids_equal = (i == ri).float().mean().item()
        t_on = _search_s(torch, st, q, True)
        t_off = _search_s(torch, st, q, False)
        nbytes = st.nbytes_host
        bound_s = nbytes / link["bytes_per_s"]
        log(f"StreamingFlatIndex {dtype} {rows:,} x {d} in {len(st.chunks)} chunks of "
            f"{st.chunk_rows:,} ({nbytes / 1e9:.3f} GB host, built in {build_s:.2f} s): vs the "
            f"resident index max|score err| {err:.3e}, ids equal {ids_equal:.4f}"
            f"{'' if plain_err is None else f', vs plain f32 {plain_err:.3e}'} (agree "
            f"{ok}); search B=64 k=10 prefetch {t_on * 1e3:.1f} ms "
            f"({nbytes / t_on / 1e9:.2f} GB/s, {bound_s / t_on:.1%} of the link bound "
            f"{bound_s * 1e3:.1f} ms), no prefetch {t_off * 1e3:.1f} ms "
            f"({nbytes / t_off / 1e9:.2f} GB/s); {own} launched {launches[own]} times, "
            f"no other kernel")
        if not ok:
            raise RuntimeError(f"streaming {dtype} differs from the resident index or plain")
        tiers[dtype] = {"rows": rows, "chunk_rows": chunk_rows, "host_bytes": nbytes,
                        "build_s": build_s, "max_abs_err": err, "ids_equal": ids_equal,
                        "plain_max_abs_err": plain_err,
                        "search_prefetch_s": t_on, "search_sync_s": t_off,
                        "link_bound_s": bound_s, "launches": launches}
        del st, res
    out["flat"] = tiers
    results["streaming"] = out
    return {"flat_topk_f32": tiers["bfloat16"]["launches"]["flat_topk_f32"],
            "int8_topk": tiers["int8"]["launches"]["int8_topk"]}


def decode_rate(torch, gen, results: dict) -> None:
    """Phase 7: decode tokens/s of the 7B-class decoder, 16 greedy steps,
    then 8 more steps under ``torch.profiler`` for the card's busy time
    (32 and 16 before phase 5c was added: the depth is cut for the run's
    time, the widths are not)."""
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
        for _ in range(16):
            logits = gen.model.decode_step(cache, logits.argmax(-1))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if not torch.isfinite(logits).all() or logits.shape != (bb, gen.cfg.vocab_size):
            raise RuntimeError("7B-class decoder logits not finite or misshapen")
        tps = bb * 16 / (t2 - t1)
        step_ms = 1e3 * (t2 - t1) / 16
        log(f"decode B={bb}: prefill {ids.shape[1]} tokens {1e3 * (t1 - t0):.1f} ms, "
            f"16 steps {step_ms:.2f} ms/step, {tps:.1f} tok/s")
        tok = logits.argmax(-1)
        prof = cuda_busy(lambda: gen.model.decode_step(cache, tok), iters=8)
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


def lm1b_config(layers: int = 16):
    from mediquery_rag_tpu_torch.config import DecoderConfig
    # the repo's 1B-class training model (benchmarks/train_attn.py MODELS["1B-class"],
    # benchmarks/corpus_train_1b.py:79): 16 MHA heads of dh 128, SwiGLU 5632
    return DecoderConfig(vocab_size=384, hidden=2048, layers=layers, heads=16,
                         mlp_dim=5632, max_len=1024, dtype="bfloat16", attn_impl="flash")


def _causal_pairs(n_real: int, heads: int) -> int:
    """Visible (query, key) pairs of one causal row block whose first
    ``S - n_real`` positions are left padding."""
    return heads * n_real * (n_real + 1) // 2


def hold_backward(torch, q, k, v, mask, dout, scale, name: str) -> tuple:
    """B6's output, then B10a and B10b on it, held per element to the plain
    backward within ``attention_grad_error_bound``; raises on a non-finite
    gradient or one outside its bound. Returns (out, D, lse, max |err| of
    dq/dk/dv, max err/bound of each)."""
    from mediquery_rag_tpu_torch.ops import attention

    off = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    o = attention.flash_prefill_cuda(q, k, v, mask, off, scale)
    D = (dout.float() * o.float()).sum(-1)
    dq, lse = attention.flash_dq_cuda(q, k, v, mask, dout, D, scale)
    dk, dv = attention.flash_dkv_cuda(q, k, v, mask, dout, lse, D, scale)
    refs = attention.flash_attention_bwd_plain(q, k, v, mask, o, dout, scale)
    bounds = attention.attention_grad_error_bound(q, k, v, mask, o, dout, scale, refs)
    errs, ratios = [], []
    for got, ref, bound in zip((dq, dk, dv), refs, bounds):
        diff = (got.float() - ref.float()).abs()
        errs.append(diff.max().item())
        ratios.append(torch.where(diff > 0, diff / bound, 0.0).max().item())
        if not torch.isfinite(got).all() or ratios[-1] > 1.0:
            raise RuntimeError(f"B10 {name}: gradient outside its bound: {ratios}")
    return o, D, lse, errs, ratios


def hold_flash(torch, mask, heads: int, dh: int, seed: int, name: str) -> tuple:
    """B6, B10a and B10b held per element to their plain versions at a
    training step's attention shape: random bf16 q, k, v of ``heads`` MHA
    heads ``dh`` wide over ``mask``'s rows and columns (right-padded rows),
    and a cotangent that is 0 on pad rows, as the masked loss gives. Raises
    outside a bound. Returns (q, k, v, dout, o, D, lse, max |err| of
    dq/dk/dv, max err/bound of each, B6's max err/bound)."""
    from mediquery_rag_tpu_torch.ops import attention

    gen = torch.Generator(device=mask.device).manual_seed(seed)
    B, S = mask.shape
    q, k, v, dout = (torch.randn((B, heads, S, dh), generator=gen, device=mask.device)
                     for _ in "qkvd")
    dout = dout * mask[:, None, :, None]
    q, k, v, dout = (t.to(torch.bfloat16) for t in (q, k, v, dout))
    scale = dh ** -0.5
    o, D, lse, errs, ratios = hold_backward(torch, q, k, v, mask, dout, scale, name)
    ref = attention.attention_plain(q, k, v, mask, scale, causal=True)
    bound = attention.attention_error_bound(q, k, v, mask, scale, ref, causal=True)
    b6_ratio = ((o.float() - ref.float()).abs() / bound).max().item()
    if b6_ratio > 1.0 or not torch.isfinite(o).all():
        raise RuntimeError(f"B6 at the {name}: err/bound {b6_ratio}")
    return q, k, v, dout, o, D, lse, errs, ratios, b6_ratio


def compare_backward(torch, table: dict) -> dict:
    """Phase 8a: B10a/B10b against the plain backward at S=4096, B=1, at
    the 1B-class widths (16 MHA heads) and the 7B-class GQA widths (28/4),
    dh 128, per element within ``attention_grad_error_bound``; CUDA-event
    times beside the plain backward's and SDPA's backward ((fwd+bwd) - fwd
    of ``scaled_dot_product_attention(is_causal=True, enable_gqa=True)``
    under autograd, a yardstick the port never calls)."""
    from mediquery_rag_tpu_torch.obs.metrics import cuda_time
    from mediquery_rag_tpu_torch.ops import attention

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    S, dh, pad = 4096, 128, 61
    scale = dh ** -0.5
    out = {}
    for name, (H, KH) in {"1B-class": (16, 16), "7B-class": (28, 4)}.items():
        q = torch.randn((1, H, S, dh), generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((1, KH, S, dh), generator=gen, device=dev).to(torch.bfloat16)
                for _ in "kv")
        mask = torch.ones((1, S), device=dev)
        mask[:, :pad] = 0
        dout = (torch.randn((1, H, S, dh), generator=gen, device=dev)
                * mask[:, None, :, None]).to(torch.bfloat16)
        o, D, lse, errs, ratios = hold_backward(torch, q, k, v, mask, dout, scale, name)
        t_dq = cuda_time(lambda: attention.flash_dq_cuda(q, k, v, mask, dout, D, scale))
        t_dkv = cuda_time(lambda: attention.flash_dkv_cuda(q, k, v, mask, dout, lse, D, scale))
        pt = cuda_time(lambda: attention.flash_attention_bwd_plain(q, k, v, mask, o, dout,
                                                                   scale), iters=2)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        t_f = cuda_time(lambda: sdpa(*leaves, is_causal=True, scale=scale, enable_gqa=True))
        t_fb = cuda_time(lambda: sdpa(*leaves, is_causal=True, scale=scale,
                                      enable_gqa=True).backward(dout))
        lib = t_fb - t_f
        pairs = _causal_pairs(S - pad, H)
        qb, kvb, rows = H * S * dh * 2, KH * S * dh * 2, H * S * 4
        b_dq = roofline(2 * qb + 2 * kvb + S * 4 + rows + qb + rows, 6 * pairs * dh, "bf16")
        b_dkv = roofline(2 * qb + 2 * kvb + S * 4 + 2 * rows + 2 * kvb, 8 * pairs * dh, "bf16")
        log(f"B10 flash backward {name} B=1 S=4096 {H}q/{KH}kv dh128 (left pad {pad}): "
            f"max|err| dq/dk/dv {errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}, max err/bound "
            f"{ratios[0]:.3f}/{ratios[1]:.3f}/{ratios[2]:.3f}; B10a {t_dq:.3f} ms (bound "
            f"{b_dq[0]:.3f} ms, {b_dq[1]}, {b_dq[0] / t_dq:.1%} of it), B10b {t_dkv:.3f} ms "
            f"(bound {b_dkv[0]:.3f} ms, {b_dkv[1]}, {b_dkv[0] / t_dkv:.1%} of it); plain "
            f"backward (both passes) {pt:.3f} ms; SDPA backward {lib:.3f} ms "
            f"(fwd+bwd {t_fb:.3f} - fwd {t_f:.3f})")
        out[name] = {"dq_ms": t_dq, "dkv_ms": t_dkv, "plain_ms": pt, "sdpa_bwd_ms": lib,
                     "sdpa_fwd_ms": t_f, "bound_dq_ms": b_dq[0], "bound_dkv_ms": b_dkv[0],
                     "max_abs_err": errs, "err_over_bound": ratios}
        del q, k, v, dout, o, D, lse, leaves
        torch.cuda.empty_cache()
    one = out["1B-class"]
    for key, ms, bound, err in (("flash_dq", "dq_ms", "bound_dq_ms", one["max_abs_err"][0]),
                                ("flash_dkv", "dkv_ms", "bound_dkv_ms",
                                 max(one["max_abs_err"][1:]))):
        table[key] = {"max_abs_err": err, "ms": one[ms], "plain_ms": one["plain_ms"],
                      "bound_ms": one[bound], "bound_by": "operations",
                      "library_ms": one["sdpa_bwd_ms"], "shape": "1B-class B=1 S=4096 16 MHA "
                      "heads dh128", "plain": "the whole plain backward (dQ, dK, dV)",
                      "library": "SDPA backward, both passes"}
    return out


def _to(tree, device):
    return ({k: _to(v, device) for k, v in tree.items()} if isinstance(tree, dict)
            else tree.detach().to(device))


def grad_parity(torch) -> dict:
    """Phase 8b: the gradient of ``lm_loss`` for a 2-layer model at the
    1B-class widths, on the card through the flash path (B6, B10a, B10b)
    and the einsum path, and on the CPU in bf16 (plain versions), each held
    to the same params in f32 on the CPU (relative L2 over every
    parameter's gradient). The card may stray at most DECODER_RATIO times
    as far as the CPU's own bf16 gradient does."""
    from dataclasses import replace

    from mediquery_rag_tpu_torch.models import optim
    from mediquery_rag_tpu_torch.models.decoder import Decoder, init_params
    from mediquery_rag_tpu_torch.models.train_lm import _leaves_on, lm_loss

    cfg = lm1b_config(layers=2)
    params = init_params(cfg, seed=SEED, device=DEVICE)
    gen = torch.Generator().manual_seed(SEED)
    B, S = 2, 256
    ids = torch.randint(3, 259, (B, S), generator=gen)
    mask = torch.ones((B, S))
    mask[0, -40:] = 0                       # right padding, as the loader pads
    mask[1, :30] = 0                        # left padding
    runs = {"card flash": (cfg, DEVICE), "card einsum": (replace(cfg, attn_impl="einsum"),
                                                         DEVICE),
            "cpu bf16": (cfg, "cpu"), "f32": (replace(cfg, dtype="float32"), "cpu")}
    grads, losses = {}, {}
    for name, (c, device) in runs.items():
        p = _leaves_on(_to(params, device), device)
        loss = lm_loss(Decoder(c, p).apply(ids, mask), ids, mask)
        g = torch.autograd.grad(loss, optim.tree_leaves(p))
        grads[name] = torch.cat([x.float().cpu().reshape(-1) for x in g])
        losses[name] = loss.item()
        del p, g
    ref = grads["f32"]
    rel = {name: ((grads[name] - ref).norm() / ref.norm()).item()
           for name in ("card flash", "card einsum", "cpu bf16")}
    ratios = {name: rel[name] / rel["cpu bf16"] for name in ("card flash", "card einsum")}
    log(f"gradient parity, 2 layers at 1B-class widths, B=2 S=256: vs f32 |dgrad|/|grad| "
        f"card flash {rel['card flash']:.3e}, card einsum {rel['card einsum']:.3e}, cpu bf16 "
        f"{rel['cpu bf16']:.3e}; ratios {ratios['card flash']:.3f} / "
        f"{ratios['card einsum']:.3f} (limit {DECODER_RATIO}); losses "
        f"{ {k: round(v, 5) for k, v in losses.items()} }")
    if max(ratios.values()) > DECODER_RATIO or not all(
            torch.isfinite(g).all() for g in grads.values()):
        raise RuntimeError(f"gradient on the card strays from the f32 reference: {ratios}")
    return {"rel_err": rel, "ratio": ratios, "loss": losses}


def train_lm_1b(torch, counters: list) -> tuple[dict, dict]:
    """Phase 8c: ``LMTrainer`` on the 1B-class model at full depth (16
    layers) over ``data/medical_data.txt``: AdamW, ``remat=True``, B=8, 10
    steps. The loss must be finite and fall; per step B6 launches twice per
    layer (the recompute runs it again) and B10a and B10b once, with the
    counters reset just before each step and read just after. Returns the
    results, the counts summed over the 10 steps and the trained params
    (for 8d and 8e). First B6 and B10a/B10b are held per element to their
    plain versions at the step's own attention shapes and the first batch's
    mask, and timed there beside SDPA."""
    import statistics
    from itertools import islice

    from mediquery_rag_tpu_torch.config import TrainConfig
    from mediquery_rag_tpu_torch.ingest import parse_corpus_file
    from mediquery_rag_tpu_torch.models import ByteTokenizer
    from mediquery_rag_tpu_torch.models.train_lm import LMLoader, LMTrainer, corpus_lm_texts
    from mediquery_rag_tpu_torch.obs.metrics import cuda_busy, cuda_time, lm_matmul_flops, mfu
    from mediquery_rag_tpu_torch.ops import attention

    cfg = lm1b_config()
    texts = corpus_lm_texts(parse_corpus_file(os.path.join(ROOT, "data", "medical_data.txt")))
    loader = LMLoader(texts, ByteTokenizer(cfg.max_len), 8, seed=SEED)
    batches = list(islice(loader.batches(1), 10))
    trainer = LMTrainer(cfg, TrainConfig(batch_size=8, lr=3e-4, warmup_steps=2,
                                         decay_steps=100, remat=True), device=DEVICE)
    t0 = time.perf_counter()
    state = trainer.init_state(SEED)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in trainer.model(state.params).buffers())
    log(f"1B-class decoder: {n_params / 1e9:.3f} B params (f32 masters), made in "
        f"{time.perf_counter() - t0:.2f} s; {len(texts)} samples, seq_len {loader.seq_len}")
    # B6 and B10a/B10b at this run's own attention shapes (B=8, 16 MHA heads,
    # dh 128) under the first batch's right-padded mask, held per element to
    # their plain versions (before the counters are reset, so these launches
    # are not counted)
    B, S, H, dh = 8, loader.seq_len, cfg.heads, cfg.hidden // cfg.heads
    mask = batches[0].mask.to(DEVICE)
    scale = dh ** -0.5
    q, k, v, dout, o, D, lse, errs, ratios, b6_ratio = hold_flash(
        torch, mask, H, dh, SEED + 9, "1B-class training shape")
    log(f"B10 flash backward at the training shape B={B} S={S} {H} heads dh{dh} (right pad, "
        f"{int(mask.sum())} of {B * S} positions real): max|err| dq/dk/dv "
        f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}, max err/bound "
        f"{ratios[0]:.3f}/{ratios[1]:.3f}/{ratios[2]:.3f}")
    # B6, B10a and B10b timed at the same shape beside SDPA (forward;
    # backward as (fwd+bwd) - fwd)
    off = torch.zeros((B,), dtype=torch.int32, device=DEVICE)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    shape_ms = {
        "flash_prefill": cuda_time(lambda: attention.flash_prefill_cuda(q, k, v, mask, off,
                                                                        scale)),
        "flash_dq": cuda_time(lambda: attention.flash_dq_cuda(q, k, v, mask, dout, D, scale)),
        "flash_dkv": cuda_time(lambda: attention.flash_dkv_cuda(q, k, v, mask, dout, lse, D,
                                                                scale)),
        "sdpa_fwd": cuda_time(lambda: sdpa(q, k, v, is_causal=True, scale=scale))}
    shape_ms["sdpa_bwd"] = cuda_time(lambda: sdpa(*leaves, is_causal=True, scale=scale)
                                     .backward(dout)) - shape_ms["sdpa_fwd"]
    log(f"B6 at the training shape: max err/bound {b6_ratio:.3f}; times (ms) B6 "
        f"{shape_ms['flash_prefill']:.4f}, B10a {shape_ms['flash_dq']:.4f}, B10b "
        f"{shape_ms['flash_dkv']:.4f}; SDPA forward {shape_ms['sdpa_fwd']:.4f}, backward "
        f"(both passes) {shape_ms['sdpa_bwd']:.4f}")
    del q, k, v, dout, mask, o, D, lse, leaves
    L = cfg.layers
    want = {"flash_prefill": 2 * L, "flash_dq": L, "flash_dkv": L}
    totals = {name: 0 for name in want}
    losses, step_s = [], []
    for i, batch in enumerate(batches):
        for fn in counters:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, batch)
        loss = m["loss"].item()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        got = {fn.__name__.removesuffix("_cuda"): fn.launches for fn in counters}
        if any(got[n] != want[n] for n in want) or not math.isfinite(loss):
            raise RuntimeError(f"training step {i}: launches {got} (want {want}), loss {loss}")
        for n in want:
            totals[n] += got[n]
        losses.append(loss)
    tokens = 8 * loader.seq_len
    ms = 1e3 * statistics.median(step_s[1:])
    flops = 3 * lm_matmul_flops(hidden=cfg.hidden, layers=L, mlp_dim=cfg.mlp_dim,
                                vocab=cfg.vocab_size, heads=cfg.heads, kv_heads=None,
                                seq_len=loader.seq_len)
    tps = tokens / (ms / 1e3)
    real = float(sum(b.mask.sum() for b in batches[1:])) / (len(batches) - 1)
    log(f"LMTrainer 1B-class, AdamW, remat=True, B=8 S={loader.seq_len}: losses "
        f"{[round(x, 4) for x in losses]}; {ms:.1f} ms/step (median of steps 2-10; step 1 "
        f"{1e3 * step_s[0]:.1f} ms), {tps:.0f} tokens/s ({real / tokens:.1%} real), model "
        f"FLOPs {flops * tokens / 1e12:.2f} TFLOP/step, MFU {mfu(flops, tps):.1%} of 989 "
        f"TFLOP/s; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
        f"per step {want}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"1B-class loss did not fall over 10 steps: {losses}")
    more = iter(batches[:2])

    def step():                            # two more steps, under the profiler
        nonlocal state
        state, _ = trainer.train_step(state, next(more))

    prof = cuda_busy(step, iters=1, top=10)
    if prof["busy_ms"] is None:
        log("training step profile: no device records, busy time not measured")
    else:
        log(f"training step profile: card busy {prof['busy_ms']:.1f} ms/step, idle "
            f"{1 - prof['busy_ms'] / ms:.1%} of the unprofiled step, "
            f"{prof['device_ops']:.0f} device ops/step")
        for name, kms, n in prof["top"]:
            log(f"    {kms:9.3f} ms x {n:5.0f}  {name}")
    out = {"profile": prof, "losses": losses, "ms_per_step": ms, "step_s": step_s, "tokens_per_s": tps,
           "real_token_share": real / tokens, "mfu": mfu(flops, tps), "seq_len": loader.seq_len,
           "n_params": n_params, "launches_per_step": want,
           "b10_train_shape": {"max_abs_err": errs, "err_over_bound": ratios},
           "b6_train_shape_err_over_bound": b6_ratio, "train_shape_ms": shape_ms,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    params = state.params
    del state, trainer
    torch.cuda.empty_cache()
    return out, totals, params


def long_context_step(torch, params) -> dict:
    """Phase 8d: one gradient step at S=4096, B=1 over the 1B-class model
    (full depth, remat=True), flash path against einsum path: ms and peak
    memory on the card."""
    from dataclasses import replace

    from mediquery_rag_tpu_torch.models import optim
    from mediquery_rag_tpu_torch.models.decoder import Decoder
    from mediquery_rag_tpu_torch.models.train_lm import lm_loss

    cfg = replace(lm1b_config(), max_len=4096)
    gen = torch.Generator().manual_seed(SEED + 4)
    S = 4096
    ids = torch.randint(3, 259, (1, S), generator=gen)
    mask = torch.ones((1, S))
    out = {}
    for impl in ("flash", "einsum"):
        dec = Decoder(replace(cfg, attn_impl=impl), params)
        leaves = optim.tree_leaves(params)
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss = lm_loss(dec.apply(ids, mask, remat=True), ids, mask)
            g = torch.autograd.grad(loss, leaves)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            del g
        peak = torch.cuda.max_memory_allocated() / 1e9
        out[impl] = {"ms": 1e3 * times[-1], "peak_gb": peak, "loss": loss.item()}
        del dec, loss
        torch.cuda.empty_cache()
    log(f"one gradient step at S=4096 B=1, 1B-class, remat=True: flash "
        f"{out['flash']['ms']:.1f} ms, peak {out['flash']['peak_gb']:.2f} GB; einsum "
        f"{out['einsum']['ms']:.1f} ms, peak {out['einsum']['peak_gb']:.2f} GB; losses "
        f"{out['flash']['loss']:.5f} / {out['einsum']['loss']:.5f}")
    if abs(out["flash"]["loss"] - out["einsum"]["loss"]) > 1e-2 * abs(out["einsum"]["loss"]):
        raise RuntimeError("flash and einsum losses disagree at S=4096")
    return out


class RecordingTokenizer:
    """A tokenizer that keeps the token ids of every row it decodes."""

    def __init__(self, tok):
        self.tok, self.rows = tok, []

    def __getattr__(self, name):
        return getattr(self.tok, name)

    def decode(self, row):
        self.rows.append([int(i) for i in row])
        return self.tok.decode(row)


def lora_1b(torch, params, counters: list) -> dict:
    """Phase 8e: ``LoraTrainer`` on the trained 1B-class base, 3 steps:
    the base stays bit-unchanged and the delta grows; the merged model,
    saved with ``Generator.save`` and loaded by ``Generator.from_checkpoint``,
    equals the merged tree leaf for leaf and decodes 8 tokens with int8
    weights through B4."""
    from itertools import islice

    from mediquery_rag_tpu_torch.config import LoraConfig, TrainConfig
    from mediquery_rag_tpu_torch.ingest import parse_corpus_file
    from mediquery_rag_tpu_torch.models import ByteTokenizer, Generator, optim
    from mediquery_rag_tpu_torch.models.lora import LoraTrainer, lora_merge
    from mediquery_rag_tpu_torch.models.train_lm import LMLoader, corpus_lm_texts

    cfg = lm1b_config()
    base = _to(params, DEVICE)
    before = [t.clone() for t in optim.tree_leaves(base)]
    texts = corpus_lm_texts(parse_corpus_file(os.path.join(ROOT, "data", "medical_data.txt")))
    loader = LMLoader(texts, ByteTokenizer(cfg.max_len), 8, seed=SEED + 1)
    trainer = LoraTrainer(cfg, LoraConfig(rank=8, alpha=16.0),
                          TrainConfig(batch_size=8, lr=1e-3, warmup_steps=1, decay_steps=10,
                                      remat=True), device=DEVICE)
    state = trainer.init_state(SEED, base)
    metrics = []
    t0 = time.perf_counter()
    for batch in islice(loader.batches(1), 3):
        state, m = trainer.train_step(state, base, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in zip(before, optim.tree_leaves(base)))
    del before
    path = os.path.join(ROOT, "build", "lora_merged")
    with torch.no_grad():
        merged = lora_merge(base, state.adapters, trainer.lora)
    Generator(cfg, merged, device=DEVICE).save(path)
    del state, trainer
    torch.cuda.empty_cache()
    tok = RecordingTokenizer(ByteTokenizer(cfg.max_len))
    gen = Generator.from_checkpoint(path, device=DEVICE, tokenizer=tok)
    # the save is f32, so the reloaded tree equals the merged one leaf for leaf
    saved = optim.tree_leaves(merged)
    loaded = optim.tree_leaves(gen.params)
    reloaded = len(saved) == len(loaded) and all(
        a.shape == b.shape and torch.equal(a.float(), b.float())
        for a, b in zip(saved, loaded))
    del merged, saved, loaded
    gen.quantize_weights(8)
    for fn in counters:
        fn.launches = 0
    prompt = "<|user|>\n高血压患者饮食注意什么？<|end|><|assistant|>\n"
    text = gen.generate([prompt], max_new_tokens=8)[0]
    launches = {fn.__name__.removesuffix("_cuda"): fn.launches for fn in counters}
    token_ids = tok.rows[0]
    log(f"LoraTrainer 1B-class rank 8, 3 steps in {dt:.2f} s: "
        f"{[{k: round(v, 4) for k, v in m.items()} for m in metrics]}; base bit-unchanged "
        f"{same}; merged model saved, reloaded equal leaf for leaf {reloaded}; int8 decode "
        f"of 8 tokens {text!r} (ids {token_ids}), launches {launches}")
    if (not same or not reloaded or metrics[-1]["delta_norm"] <= 0
            or launches["matvec_int8"] <= 0):
        raise RuntimeError(f"LoRA phase failed: base unchanged {same}, reloaded {reloaded}, "
                           f"{metrics[-1]}, {launches}")
    del gen
    torch.cuda.empty_cache()
    return {"steps": metrics, "s": dt, "base_unchanged": same, "reloaded_equal": reloaded,
            "text": text, "token_ids": token_ids, "decode_launches": launches}


def training(torch, results: dict, table: dict) -> dict:
    """Phase 8: the LM training path (8a-8e). Returns the launch counts of
    the 1B-class training run (8c), the main path of this phase."""
    from mediquery_rag_tpu_torch.ops import attention, matvec

    out = {"kernels": compare_backward(torch, table)}
    out["grad_parity"] = grad_parity(torch)
    counters = [attention.flash_prefill_cuda, attention.flash_dq_cuda,
                attention.flash_dkv_cuda]
    out["train_1b"], totals, params = train_lm_1b(torch, counters)
    out["long_context"] = long_context_step(torch, params)
    out["lora"] = lora_1b(torch, params, counters + [matvec.matvec_int8_cuda])
    results["training"] = out
    del params
    torch.cuda.empty_cache()
    return totals


# -- phase 12: the trainers' data/model mesh --------------------------------------

P12_LAYERS = 4           # phase 12: the 1B-class widths at a cut depth (16 in phase 8)
P12_STEPS = 3            # (a)'s steps; (b) runs the first 2 of them
P12_SAME_REL = 1e-4      # (a): the world-size-1 mesh against mesh=None: the same operations
                         # but for B10a/B10b's f32 atomics summed in another order
P12_LOSS_REL = 1e-3      # (b): bf16 products summed over 2 ranks in another order
P12_PARAM_REL = 2e-3     # (b): per leaf ||p - p_a|| / ||p_a|| after 2 steps; the 2 steps
                         # move a leaf by ~7e-3 of its norm, so a rank's lost gradient shows


def _p12_batches(torch):
    from itertools import islice

    from mediquery_rag_tpu_torch.ingest import parse_corpus_file
    from mediquery_rag_tpu_torch.models import ByteTokenizer
    from mediquery_rag_tpu_torch.models.train_lm import LMLoader, corpus_lm_texts

    cfg = lm1b_config(P12_LAYERS)
    texts = corpus_lm_texts(parse_corpus_file(os.path.join(ROOT, "data", "medical_data.txt")))
    loader = LMLoader(texts, ByteTokenizer(cfg.max_len), 8, seed=SEED)
    return cfg, [(b.ids.numpy(), b.mask.numpy()) for b in islice(loader.batches(1), P12_STEPS)]


def _p12_train(torch, mesh, cfg, batches, ref: str | None = None) -> dict:
    """``LMTrainer(mesh=)`` over ``batches`` on this rank: losses, ms per
    step, peak memory, each step's B6/B10a/B10b launches (counters reset
    just before the steps, read just after), the gathered params (or,
    given ``ref``, each leaf's relative distance from those saved there)."""
    from mediquery_rag_tpu_torch.config import TrainConfig
    from mediquery_rag_tpu_torch.models.train_lm import LMBatch, LMTrainer
    from mediquery_rag_tpu_torch.ops import attention
    from mediquery_rag_tpu_torch.parallel.dist import tree_get, tree_paths

    dev = DEVICE if mesh is None else mesh.device
    trainer = LMTrainer(cfg, TrainConfig(batch_size=8, lr=3e-4, warmup_steps=2,
                                         decay_steps=100, remat=True), mesh=mesh, device=dev)
    state = trainer.init_state(SEED)
    counters = [attention.flash_prefill_cuda, attention.flash_dq_cuda, attention.flash_dkv_cuda]
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in counters:
        fn.launches = 0
    losses, ms = [], []
    for ids, mask in batches:
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, LMBatch(torch.from_numpy(ids),
                                                     torch.from_numpy(mask)))
        losses.append(m["loss"].item())
        torch.cuda.synchronize(dev)
        ms.append(1e3 * (time.perf_counter() - t0))
    out = {"losses": losses, "ms": ms, "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "launches": {fn.__name__.removesuffix("_cuda"): fn.launches for fn in counters}}
    full = trainer.gather_params(state.params)
    paths = tree_paths(full)
    if ref is None:
        out["params"] = {p: tree_get(full, p).detach().cpu() for p in paths}
    else:
        want = torch.load(ref)
        out["param_rel"] = {"/".join(p): ((tree_get(full, p).detach().cpu() - want[p]).norm()
                                          / want[p].norm()).item() for p in paths}
    return out


def _p12_rank(mesh, cfg, batches, ref) -> dict:
    """Phase 12 (b) on one of 2 spawned ranks: the steps at tp=2 (``mesh``)
    and, over the same 2 processes, at dp=2, each after B6/B10a/B10b are
    held per element to their plain versions at this rank's own attention
    shape (its heads, its rows of the first batch's mask)."""
    import torch
    import torch.distributed as dist

    from mediquery_rag_tpu_torch.parallel.dist import init_train_mesh

    out = {}
    for name, m in (("tp=2", mesh), ("dp=2", None)):
        m = m or init_train_mesh(2, 1, device=mesh.device)
        mask = torch.from_numpy(batches[0][1][m.rows(len(batches[0][1]))]).to(m.device)
        heads, dh = cfg.heads // m.tp, cfg.hidden // cfg.heads
        *_, errs, ratios, b6_ratio = hold_flash(torch, mask, heads, dh, SEED + 12,
                                                f"{name} rank shape")
        hold = {"B": mask.shape[0], "heads": heads, "b10_max_abs_err": errs,
                "b10_err_over_bound": ratios, "b6_err_over_bound": b6_ratio}
        del mask
        torch.cuda.empty_cache()
        out[name] = {**_p12_train(torch, m, cfg, batches, ref), "rank": dist.get_rank(),
                     "data_rank": m.data_rank, "model_rank": m.model_rank, "hold": hold}
    return out


def distributed_training(torch, results: dict, card: str) -> dict:
    """Phase 12: ``LMTrainer(mesh=)`` on the 1B-class widths (hidden 2048,
    16 MHA heads, MLP 5632, vocab 384) at 4 layers, B=8 over the corpus,
    AdamW, remat=True. (a) A world-size-1 NCCL mesh, 3 steps, against
    ``LMTrainer(mesh=None)`` from the same init: losses and params within
    P12_SAME_REL; at world size 1 the mesh's groups are None and every
    collective is the identity, so (a) runs no NCCL collective. (b) Two
    processes sharing the card over gloo (NCCL refuses two ranks on one
    card; gloo stages CUDA tensors through the host), tp=2 and then dp=2
    (one spawn), 2 steps each: B6/B10a/B10b first held per element to their
    plain versions at the rank's own shape (8 heads at tp=2, 4 rows at
    dp=2), then losses within P12_LOSS_REL of (a)'s and every leaf within
    P12_PARAM_REL of (a)'s after 2 steps. Each rank's launches per step
    must be B6 2L (the recompute runs it again), B10a L and B10b L on its
    heads. A 4-card dp=2 x tp=2 NCCL run needs a 4-card host. Returns the
    launches of the mesh runs, summed over ranks."""
    import tempfile

    from mediquery_rag_tpu_torch.parallel.dist import init_train_mesh, launch

    cfg, batches = _p12_batches(torch)
    L = cfg.layers
    want = {"flash_prefill": 2 * L, "flash_dq": L, "flash_dkv": L}
    out, totals = {"card": card}, {n: 0 for n in want}

    def check(name, run, steps):
        per = {n: v / steps for n, v in run["launches"].items()}
        if per != want or not all(math.isfinite(x) for x in run["losses"]):
            raise RuntimeError(f"12 {name}: launches per step {per} (want {want}), "
                               f"losses {run['losses']}")
        for n in want:
            totals[n] += run["launches"][n]

    one = _p12_train(torch, None, cfg, batches)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        mesh = init_train_mesh(1, 1, "nccl", device="cuda:0",
                               init_method="file://" + os.path.join(tmp, "store"), rank=0,
                               world_size=1)
        try:
            a = _p12_train(torch, mesh, cfg, batches)
        finally:
            torch.distributed.destroy_process_group()
    check("(a) world size 1, NCCL", a, P12_STEPS)
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(a["losses"], one["losses"]))
    same = max(((a["params"][p] - one["params"][p]).norm() / one["params"][p].norm()).item()
               for p in one["params"])
    log(f"12 (a) LMTrainer 1B-class widths x {L} layers, B=8 S={batches[0][0].shape[1]}, "
        f"world size 1 over NCCL: losses {[round(x, 4) for x in a['losses']]} (mesh=None "
        f"{[round(x, 4) for x in one['losses']]}), max relative loss gap {loss_rel:.2e}, "
        f"params {same:.2e}; {[round(x, 1) for x in a['ms']]} ms/step (mesh=None "
        f"{[round(x, 1) for x in one['ms']]}); peak {a['peak_gb']:.2f} GB (mesh=None "
        f"{one['peak_gb']:.2f}); {card}")
    if loss_rel > P12_SAME_REL or same > P12_SAME_REL:
        raise RuntimeError(f"12 (a): the world-size-1 mesh departs from mesh=None: losses "
                           f"{loss_rel:.2e}, params {same:.2e}")
    out["a"] = {k: v for k, v in a.items() if k != "params"}
    out["a"].update(none_ms=one["ms"], none_peak_gb=one["peak_gb"], loss_rel=loss_rel,
                    param_rel=same)
    # (a)'s params after 2 steps, the reference of (b)
    two = _p12_train(torch, None, cfg, batches[:2])
    ref = os.path.join(ROOT, "build", "p12_ref.pt")
    torch.save(two["params"], ref)
    ref_losses = two["losses"]
    del one, a, two
    gc_cuda(torch)
    try:
        t0 = time.perf_counter()
        both = launch(_p12_rank, 1, 2, cfg, batches[:2], ref, device="cuda:0", timeout=600)
        log(f"12 (b): {time.perf_counter() - t0:.1f} s with the spawn")
        for name in ("tp=2", "dp=2"):
            ranks = [r[name] for r in both]
            for r in ranks:
                check(f"(b) {name} rank {r['rank']}", r, 2)
                loss_rel = max(abs(x - y) / abs(y) for x, y in zip(r["losses"], ref_losses))
                worst = max(r["param_rel"].items(), key=lambda kv: kv[1])
                h = r["hold"]
                log(f"12 (b) {name} rank {r['rank']}: at its shape B={h['B']} {h['heads']} "
                    f"heads B6 max err/bound {h['b6_err_over_bound']:.3f}, B10 dq/dk/dv max "
                    f"|err| {'/'.join(f'{e:.3e}' for e in h['b10_max_abs_err'])}, max "
                    f"err/bound {'/'.join(f'{x:.3f}' for x in h['b10_err_over_bound'])}")
                log(f"12 (b) {name} rank {r['rank']} (data {r['data_rank']}, model "
                    f"{r['model_rank']}), 2 processes on one card over gloo: losses "
                    f"{[round(x, 4) for x in r['losses']]} (max relative gap to (a) "
                    f"{loss_rel:.2e}), params max relative distance {worst[1]:.2e} "
                    f"({worst[0]}); {[round(x, 1) for x in r['ms']]} ms/step; peak "
                    f"{r['peak_gb']:.2f} GB; launches {r['launches']}; {card}")
                if loss_rel > P12_LOSS_REL or worst[1] > P12_PARAM_REL:
                    raise RuntimeError(f"12 (b) {name}: losses {loss_rel:.2e}, params "
                                       f"{worst[1]:.2e} from (a)")
            out[name] = {"ranks": ranks}
    finally:
        os.remove(ref)
    log("12: a dp=2 x tp=2 NCCL run needs four cards (not run on this host)")
    results["distributed_training"] = out
    return totals


# -- phase 13: tensor-parallel generation ---------------------------------------

P13_LAYERS = 28          # phase 13: Qwen2.5-7B's widths and depth
P13_TOKENS = 32          # (a): greedy tokens a prompt
P13_INT8_TOKENS = 8      # (b): a short lockstep run
P13_PROMPTS = (QUESTIONS[0], QUESTIONS[1] * 6)    # 49 and 217 byte tokens: the prefill runs
                                                   # the dequantized product (2 x 256 rows)
P13_SERVE_BYTES = (300, 700, 1100, 1500)   # (c): the first admitted whole, the rest in pieces
P13_SERVE_TOKENS = 16    # (c): tokens a request
P13_SERVE = dict(slots=4, chunk=8, cache_len=2048, prefill_chunk=256)


def _p13_prompts() -> list[str]:
    raw = open(os.path.join(ROOT, "data", "medical_data.txt"), encoding="utf-8").read().encode()
    return [raw[:n].decode("utf-8", errors="ignore") for n in P13_SERVE_BYTES]


class _Calls:
    """Wraps ``model.<name>`` for each name: counts the calls and sums
    their milliseconds, each call bracketed by ``torch.cuda.synchronize``."""

    def __init__(self, torch, model, names):
        self.torch, self.n, self.ms = torch, dict.fromkeys(names, 0), dict.fromkeys(names, 0.0)
        for name in names:
            setattr(model, name, self._wrap(name, getattr(model, name)))

    def _wrap(self, name, fn):
        def call(*a, **kw):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.torch.cuda.synchronize()
            self.ms[name] += 1e3 * (time.perf_counter() - t0)
            self.n[name] += 1
            return out
        return call


class _Capture:
    """While entered, clones the arguments of the calls numbered ``keep``
    (from 0) of the kernel wrapper ``name`` of module ``mod``; the wrapper
    still launches, and its launch count carries over."""

    def __init__(self, torch, mod, name: str, keep):
        self.torch, self.mod, self.name, self.keep = torch, mod, name, set(keep)
        self.calls: dict = {}

    def __enter__(self):
        orig, torch, seen = getattr(self.mod, self.name), self.torch, [0]

        def call(*a, **kw):
            if seen[0] in self.keep:
                self.calls[seen[0]] = (
                    [x.clone() if torch.is_tensor(x) else x for x in a],
                    {k: x.clone() if torch.is_tensor(x) else x for k, x in kw.items()})
            seen[0] += 1
            return orig(*a, **kw)

        call.launches = orig.launches
        self.orig = orig
        setattr(self.mod, self.name, call)
        return self

    def __exit__(self, *exc):
        self.orig.launches = getattr(self.mod, self.name).launches
        setattr(self.mod, self.name, self.orig)


def _p13_attn_hold(torch, name: str, call) -> dict:
    """Relaunch the captured ``call`` (args, kwargs) of the attention
    wrapper ``name`` and hold it to its plain version on the same inputs
    within ``attention_error_bound``: ``attention_plain`` for the bf16
    routes, ``flash_plain`` for an int8 cache or the fresh-column fold. A
    prefill's query rows that see no key (left padding) are not held: the
    kernel and the plain version differ there by design. An element both
    give exactly (a zero code seen by a row with one key: bound 0) holds.
    Raises above 1.0."""
    from mediquery_rag_tpu_torch.ops import attention

    a, kw = call
    o = getattr(attention, name)(*a, **kw)
    causal = name.startswith("flash_prefill")
    int8 = name.endswith("_int8_cuda")
    q, k, v = a[:3]
    ks, vs = a[3:5] if int8 else (None, None)
    rest = a[5:] if int8 else a[3:]
    km, off, scale = rest if causal else (rest[0], None, rest[1])
    common = dict(causal=causal, q_offset=off, k_scale=ks, v_scale=vs, **kw)
    ref = (attention.flash_plain(q, k, v, km, scale, **common) if int8 or kw
           else attention.attention_plain(q, k, v, km, scale, causal=causal, q_offset=off))
    bound = attention.attention_error_bound(q, k, v, km, scale, ref, **common)
    held = attention._visible(km, q.shape[2], k.shape[2], causal, off).any(-1, keepdim=True)
    diff = (o.float() - ref.float()).abs()
    ratio = torch.where(diff == 0, 0.0, diff / bound)[held.expand_as(o)].max().item()
    rec = {"q": list(q.shape), "k": list(k.shape), "rows_held": int(held.sum()),
           "err_over_bound": ratio}
    if not ratio <= 1.0:
        raise RuntimeError(f"13: {name} at the rank's shape disagrees with plain: {rec}")
    return rec


def _p13_hold(torch, gen, prompts, bits: int) -> dict:
    """This rank's kernels held per element to their plain versions at its
    own shapes, on the inputs of a 2-token generation (one prefill, one
    decode step): B7 (int4) or B4 (int8) at the prefill's lm_head (the
    vocab cut) and the decode step's layer-0 qkv (a column cut), attn_out
    and w_down (row cuts), bit-equal; B6 at the prefill's layer 0 and B5
    at the decode step's layer 0 (over the int8 cache with int4 weights,
    the bf16 cache with int8 weights), by ``_p13_attn_hold``. These
    launches are counted before the phase's counters are reset."""
    from mediquery_rag_tpu_torch.ops import attention, matvec

    # the calls in order: the prefill's lm_head over its 2 last rows (its 512-row
    # products dequantize), then the decode step's qkv, attn_out, (gate, up | gateup),
    # down in each layer
    keep = {0: "lm_head", 1: "qkv", 2: "attn_out", 5 if bits == 4 else 4: "w_down"}
    kernel = "matvec_int4_cuda" if bits == 4 else "matvec_int8_cuda"
    b5_name = "flash_decode_int8_cuda" if bits == 4 else "flash_decode_cuda"
    with _Capture(torch, matvec, kernel, keep) as mv, \
            _Capture(torch, attention, "flash_prefill_cuda", {0}) as b6, \
            _Capture(torch, attention, b5_name, {0}) as b5:
        gen.generate(prompts, max_new_tokens=2)
    out = {}
    for i, name in keep.items():
        a, _ = mv.calls[i]
        got = getattr(matvec, kernel)(*a)
        ref = (matvec.int4_matmul_plain(*a) if bits == 4 else matvec.int8_matmul_plain(*a))
        w = list(a[2 if bits == 4 else 1].shape)
        if not torch.equal(got, ref):
            raise RuntimeError(f"13: {kernel} at {name} {w} not bit-equal: "
                               f"{(got - ref).abs().max().item()}")
        out[f"{'B7' if bits == 4 else 'B4'} {name}"] = {"x": list(a[0].shape), "w": w,
                                                        "bit_equal": True}
    for label, cap in (("B6", b6), ("B5 int8" if bits == 4 else "B5", b5)):
        if 0 not in cap.calls:
            raise RuntimeError(f"13: {cap.name} was not called in the held generation")
        out[label] = _p13_attn_hold(torch, cap.name, cap.calls[0])
    return out


def _p13_lockstep(torch, gen, prompts, tokens: int, counters: list) -> dict:
    """``generate_tokens`` (the lockstep path), with every counter of
    ``counters`` reset just before and read just after, the prefill and
    each decode step timed, and the peak memory."""
    dev = gen.device
    calls = _Calls(torch, gen.model, ("prefill", "decode_step"))
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    toks = gen.generate_tokens(prompts, max_new_tokens=tokens)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    steps = calls.n["decode_step"]
    return {"tokens": toks, "wall_s": wall, "decode_steps": steps,
            "prefill_ms": calls.ms["prefill"], "step_ms": calls.ms["decode_step"] / max(steps, 1),
            "launches": {fn.__name__.removesuffix("_cuda"): fn.launches for fn in counters},
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def _p13_serve(torch, gen, prompts, counters: list, lead: bool = True,
               hold: bool = False) -> dict:
    """(c): ``LLMServer`` over ``gen`` (P13_SERVE); the lead submits every
    prompt at once and reads the replies, a follower rank follows. The
    counters are reset just before the server starts and read after it
    closes. With ``hold``, the run's first B6 int8 piece is captured and,
    after the counters are read, held to plain (``_p13_attn_hold``)."""
    from mediquery_rag_tpu_torch.ops import attention
    from mediquery_rag_tpu_torch.serve.llm import LLMServer

    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize(gen.device)
    t0 = time.perf_counter()
    with _Capture(torch, attention, "flash_prefill_int8_cuda", {0} if hold else ()) as piece:
        srv = LLMServer(gen, **P13_SERVE)
        if not lead:
            finished = srv.follow()
        else:
            try:
                futs = [srv.submit(p, max_new_tokens=P13_SERVE_TOKENS) for p in prompts]
                for f in futs:
                    f.result(timeout=600)
                replies = [_reply_tokens(f, gen.tokenizer.eos_id) for f in futs]
            finally:
                srv.close()
    if not lead:
        out = {"finished": finished}
    else:
        wall = time.perf_counter() - t0
        lat = srv.latency()
        out = {"replies": replies, "finished": list(srv.finished or ()), "wall_s": wall,
               "tok_s": srv.stats["tokens_out"] / wall, "ttft_p50_s": lat["ttft_p50_s"],
               "ttft_p99_s": lat["ttft_p99_s"], "prefill_pieces": srv.stats["prefill_pieces"],
               "pick_mismatches": gen.pick_mismatches}
    out["launches"] = {fn.__name__.removesuffix("_cuda"): fn.launches for fn in counters}
    if hold:
        if 0 not in piece.calls:
            raise RuntimeError("13 (c): no prefill piece over the int8 cache was launched")
        out["hold"] = {"B6 int8 piece": _p13_attn_hold(torch, piece.name, piece.calls[0])}
    return out


def _p13_collectives(torch, mesh, cfg, reps: int = 50) -> dict:
    """Host ms a call of each serving collective at a lockstep decode step's
    shapes (2 rows), on this rank, the card synchronized after each call:
    the residual all-reduce of [2, 1, hidden] f32, the row scales' MAX
    all-reduce of [2, 1], the logits' all-gather of [2, vocab / tp] and the
    broadcast of 2 picked tokens; and their sum over one decode step (2L
    of each all-reduce, one gather, one broadcast)."""
    from mediquery_rag_tpu_torch.parallel import collectives as cc

    g, dev = mesh.model_group, mesh.device
    calls = {
        "all_reduce_sum": lambda: cc.all_reduce(torch.ones((2, 1, cfg.hidden), device=dev), g),
        "all_reduce_max": lambda: cc.all_reduce_max(torch.ones((2, 1), device=dev), g),
        "all_gather": lambda: cc.all_gather(torch.ones((2, cfg.vocab_size // mesh.tp),
                                                       device=dev), g),
        "broadcast": lambda: cc.broadcast_from_model(torch.ones(2, dtype=torch.long,
                                                                device=dev), g)}
    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
            torch.cuda.synchronize(dev)
        out[name] = 1e3 * (time.perf_counter() - t0) / reps
    L = cfg.layers
    out["step_sum"] = (2 * L * (out["all_reduce_sum"] + out["all_reduce_max"])
                       + out["all_gather"] + out["broadcast"])
    return out


def _p13_rank(mesh, cfg, prompts, serve_prompts) -> dict:
    """Phase 13 on one of 2 spawned ranks sharing the card: (a) int4 + int8
    KV, (c) ``LLMServer`` (rank 0 serves, rank 1 follows), then (b) int8
    weights; each generator drawn whole from the seed (``init_params(bits=)``,
    quantized layer by layer) and cut to this rank's shard, its kernels held
    to plain at the rank's shapes before the counted runs."""
    import dataclasses

    import torch

    from mediquery_rag_tpu_torch.models.decoder import init_params
    from mediquery_rag_tpu_torch.models.generate import Generator
    from mediquery_rag_tpu_torch.ops import attention, matvec

    dev = mesh.device
    lead = mesh.model_rank == 0
    out = {"rank": mesh.model_rank}
    a_counters = [matvec.matvec_int4_cuda, attention.flash_decode_int8_cuda,
                  attention.flash_prefill_cuda, attention.flash_prefill_int8_cuda]
    t0 = time.perf_counter()
    gen = Generator(cfg, init_params(cfg, seed=SEED, device=dev, bits=4), mesh=mesh)
    gc_cuda(torch)
    out["a_build_s"] = time.perf_counter() - t0
    out["a_hold"] = _p13_hold(torch, gen, prompts, 4)
    out["a"] = _p13_lockstep(torch, gen, prompts, P13_TOKENS, a_counters)
    out["collectives_ms"] = _p13_collectives(torch, mesh, cfg)
    out["c"] = _p13_serve(torch, gen, serve_prompts, a_counters, lead, hold=True)
    del gen
    gc_cuda(torch)
    cfg8 = dataclasses.replace(cfg, kv_dtype="")
    gen = Generator(cfg8, init_params(cfg8, seed=SEED, device=dev, bits=8), mesh=mesh)
    gc_cuda(torch)
    out["b_hold"] = _p13_hold(torch, gen, prompts, 8)
    out["b"] = _p13_lockstep(torch, gen, prompts, P13_INT8_TOKENS,
                             [matvec.matvec_int8_cuda, attention.flash_decode_cuda,
                              attention.flash_prefill_cuda])
    del gen
    gc_cuda(torch)
    return out


def _p13_agree(torch, label: str, cfg, bits: int, prompts, want: list, got: list,
               tie_gap: float, ref: dict) -> list:
    """Each pair of token lists equal, or first apart at a near tie: the gap
    from the smaller of the two tokens' logits to the maximum, on the
    world-size-1 model (rebuilt from the seed once, into ``ref``), within
    ``tie_gap``."""
    from mediquery_rag_tpu_torch.models.decoder import init_params
    from mediquery_rag_tpu_torch.models.generate import Generator

    out = []
    for prompt, a, b in zip(prompts, want, got):
        if a == b:
            out.append(None)
            continue
        if bits not in ref:
            ref.clear()
            gc_cuda(torch)
            ref[bits] = Generator(cfg, init_params(cfg, seed=SEED, device=DEVICE, bits=bits),
                                  device=DEVICE)
        d = first_divergence(torch, ref[bits], prompt, a, b)
        out.append(d)
        if d["gap"] > tie_gap:
            raise RuntimeError(f"13 {label}: tp=2 departs from world size 1 at token "
                               f"{d['pos']} with gap {d['gap']:.3f} > {tie_gap:.3f}: {d}")
    return out


def tp_generation(torch, results: dict, card: str) -> dict:
    """Phase 13: generation over a tensor-parallel mesh at Qwen2.5-7B's
    widths (phase 5b's config at P13_LAYERS layers, seed-0 weights), two
    gloo ranks sharing the card (NCCL refuses two ranks on one card; gloo
    stages every collective through the host, so the collective times are
    gloo's host staging, not NVLink's): (a) int4 weights + an int8 KV
    cache, 2 prompts (one of 217 tokens) x 32 greedy tokens through
    ``Generator.generate_tokens``; (c) ``LLMServer`` on rank 0 with rank 1
    following, 4 requests of 300-1,500 bytes, the last three landing in
    256-token pieces (B6 int8); (b) int8 weights (B4), 8 tokens. The
    world-size-1 runs go first in this process, on the same seed's weights,
    and are freed before the spawn. On each rank the kernels of the path
    are held to plain at its shapes (``_p13_hold``); the tokens of every
    run equal world size 1's or first part at a near tie (phase 5c's bound);
    the follower finishes the same requests with the same tokens; each
    lockstep decode step launches B7 5L + 1 and B5 int8 L times (B4 4L + 1
    and B5 L in (b)) on each rank, the prefill one more B7 (B4) for its
    logits. Returns the ranks' launches, summed."""
    import dataclasses

    from mediquery_rag_tpu_torch.models.decoder import init_params
    from mediquery_rag_tpu_torch.models.generate import Generator
    from mediquery_rag_tpu_torch.ops import attention, matvec
    from mediquery_rag_tpu_torch.parallel.dist import launch

    cfg = dataclasses.replace(qwen7b_config(P13_LAYERS), kv_dtype="int8")
    cfg8 = dataclasses.replace(cfg, kv_dtype="")
    L = cfg.layers
    prompts, serve_prompts = list(P13_PROMPTS), _p13_prompts()
    tie_gap = 2 * results["decoder_parity"]["cpu_bf16_max_logit_dev"]
    counters = [matvec.matvec_int4_cuda, attention.flash_decode_int8_cuda,
                attention.flash_prefill_cuda, attention.flash_prefill_int8_cuda]
    out = {"card": card, "layers": L, "tie_gap": tie_gap}
    gen = Generator(cfg, init_params(cfg, seed=SEED, device=DEVICE, bits=4), device=DEVICE)
    one_a = _p13_lockstep(torch, gen, prompts, P13_TOKENS, counters)
    one_c = _p13_serve(torch, gen, serve_prompts, counters)
    del gen
    gc_cuda(torch)
    gen = Generator(cfg8, init_params(cfg8, seed=SEED, device=DEVICE, bits=8), device=DEVICE)
    one_b = _p13_lockstep(torch, gen, prompts, P13_INT8_TOKENS,
                          [matvec.matvec_int8_cuda, attention.flash_decode_cuda,
                           attention.flash_prefill_cuda])
    del gen
    gc_cuda(torch)
    t0 = time.perf_counter()
    ranks = launch(_p13_rank, 1, 2, cfg, prompts, serve_prompts, device="cuda:0", timeout=600)
    out["spawn_and_ranks_s"] = time.perf_counter() - t0
    totals = collections.Counter()
    ref: dict = {}
    for r in ranks:
        a, b, c = r["a"], r["b"], r["c"]
        # a decode step: 5L + 1 (4L + 1) products and L attentions; the prefill's
        # 2 rows of lm_head add one product
        for run, mv, per in ((a, "matvec_int4", 5 * L + 1), (b, "matvec_int8", 4 * L + 1)):
            n, dec = run["decode_steps"], ("flash_decode_int8" if run is a else "flash_decode")
            want = {mv: n * per + 1, dec: n * L}
            if {k: run["launches"][k] for k in want} != want:
                raise RuntimeError(f"13 rank {r['rank']}: launches {run['launches']} over {n} "
                                   f"decode steps, want {want}")
        for run in (a, b, c):
            totals.update(run["launches"])
        log(f"13 rank {r['rank']} kernels at its shapes: "
            + "; ".join(f"{k} {v}" for k, v in {**r["a_hold"], **r["c"]["hold"],
                                                **r["b_hold"]}.items()))
        log(f"13 (a) rank {r['rank']} int4 + int8 KV, tp=2 ({L} layers, {cfg.heads // 2} q / "
            f"{cfg.kv_heads // 2} KV heads a rank): {a['step_ms']:.1f} ms a decode step (world "
            f"size 1 {one_a['step_ms']:.1f}), "
            f"prefill {a['prefill_ms']:.1f} ms (world size 1 {one_a['prefill_ms']:.1f}), "
            f"{a['decode_steps']} steps, peak {a['peak_gb']:.2f} GB (world size 1 "
            f"{one_a['peak_gb']:.2f}), launches {a['launches']}; {card}")
        log(f"13 (b) rank {r['rank']} int8 weights: {b['step_ms']:.1f} ms a decode step (world "
            f"size 1 {one_b['step_ms']:.1f}), launches {b['launches']}; {card}")
        log(f"13 rank {r['rank']} gloo collectives, host ms a call at a decode step's shapes "
            f"(2 rows): " + ", ".join(f"{k} {v:.3f}" for k, v in r["collectives_ms"].items())
            + f" (step_sum: 2L of each all-reduce, a gather, a broadcast); {card}")
        out[f"rank{r['rank']}"] = r
    lead, follower = ranks[0], ranks[1]
    for label, want, got, bits, ps in (
            ("(a)", one_a["tokens"], lead["a"]["tokens"], 4, prompts),
            ("(b)", one_b["tokens"], lead["b"]["tokens"], 8, prompts),
            ("(c)", one_c["replies"], lead["c"]["replies"], 4, serve_prompts)):
        out[f"divergence_{label}"] = _p13_agree(
            torch, label, cfg if bits == 4 else cfg8, bits, ps, want, got, tie_gap, ref)
    del ref
    gc_cuda(torch)
    for run in ("a", "b"):
        if follower[run]["tokens"] != lead[run]["tokens"]:
            raise RuntimeError(f"13 ({run}): the ranks' tokens differ")
    if follower["c"]["finished"] != lead["c"]["finished"] or len(lead["c"]["finished"]) != 4:
        raise RuntimeError("13 (c): the follower finished other requests or tokens")
    c = lead["c"]
    if c["prefill_pieces"] < 3 or c["pick_mismatches"]:
        raise RuntimeError(f"13 (c): {c['prefill_pieces']} prefill pieces, "
                           f"{c['pick_mismatches']} greedy picks apart from rank 0's")
    log(f"13 (c) LLMServer tp=2 (rank 0 serves, rank 1 follows), 4 requests of "
        f"{P13_SERVE_BYTES} bytes x {P13_SERVE_TOKENS} tokens: {c['tok_s']:.2f} tok/s, TTFT "
        f"p50 {c['ttft_p50_s']:.2f} s, {c['prefill_pieces']} prefill pieces, wall "
        f"{c['wall_s']:.1f} s (world size 1: {one_c['tok_s']:.2f} tok/s, TTFT p50 "
        f"{one_c['ttft_p50_s']:.2f} s, wall {one_c['wall_s']:.1f} s); launches rank 0 "
        f"{c['launches']}, rank 1 {follower['c']['launches']}; {card}")
    for name in ("matvec_int4", "matvec_int8", "flash_decode_int8", "flash_prefill",
                 "flash_prefill_int8"):
        if totals[name] <= 0:
            raise RuntimeError(f"13: {name} was not launched over the mesh")
    out.update(one_a={k: v for k, v in one_a.items() if k != "tokens"},
               one_b={k: v for k, v in one_b.items() if k != "tokens"},
               one_c={k: v for k, v in one_c.items() if k not in ("replies", "finished")})
    log("13: NCCL over NVLink needs one card a rank (not on this host)")
    results["tp_generation"] = out
    return dict(totals)


# -- phase 9: HF checkpoints written by hand, served through the CLI ----------

# Qwen/Qwen2.5-7B-Instruct config.json (the fields the importer reads, and its ids)
QWEN25_7B = {
    "architectures": ["Qwen2ForCausalLM"], "model_type": "qwen2", "hidden_act": "silu",
    "hidden_size": 3584, "intermediate_size": 18944, "num_hidden_layers": 28,
    "num_attention_heads": 28, "num_key_value_heads": 4, "vocab_size": 152064,
    "max_position_embeddings": 32768, "rope_theta": 1000000.0, "rms_norm_eps": 1e-06,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16", "bos_token_id": 151643,
    "eos_token_id": 151645, "initializer_range": 0.02}
QWEN_SPECIALS = {"<|endoftext|>": 151643, "<|im_start|>": 151644, "<|im_end|>": 151645}
# bert-base-chinese config.json (BertEmbedderConfig's defaults)
BERT_BASE_ZH = {
    "architectures": ["BertModel"], "model_type": "bert", "hidden_act": "gelu",
    "hidden_size": 768, "intermediate_size": 3072, "num_hidden_layers": 12,
    "num_attention_heads": 12, "vocab_size": 21128, "max_position_embeddings": 512,
    "type_vocab_size": 2, "layer_norm_eps": 1e-12, "initializer_range": 0.02}
BPE_MERGES = 4000        # merges learned from the corpus for the BPE tokenizer
_ST_BYTES = {"BF16": 2, "F32": 4}


def qwen2_tensor_specs(cfg: dict) -> list[tuple[str, str, tuple]]:
    """(name, safetensors dtype, shape) of every tensor of a qwen2
    checkpoint, HF Linear weights ``[out, in]``, in file order."""
    D, F, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    dh = D // cfg["num_attention_heads"]
    kvd = cfg["num_key_value_heads"] * dh
    specs = [("model.embed_tokens.weight", "BF16", (V, D))]
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        specs += [(p + "input_layernorm.weight", "BF16", (D,)),
                  (p + "self_attn.q_proj.weight", "BF16", (D, D)),
                  (p + "self_attn.q_proj.bias", "BF16", (D,)),
                  (p + "self_attn.k_proj.weight", "BF16", (kvd, D)),
                  (p + "self_attn.k_proj.bias", "BF16", (kvd,)),
                  (p + "self_attn.v_proj.weight", "BF16", (kvd, D)),
                  (p + "self_attn.v_proj.bias", "BF16", (kvd,)),
                  (p + "self_attn.o_proj.weight", "BF16", (D, D)),
                  (p + "post_attention_layernorm.weight", "BF16", (D,)),
                  (p + "mlp.gate_proj.weight", "BF16", (F, D)),
                  (p + "mlp.up_proj.weight", "BF16", (F, D)),
                  (p + "mlp.down_proj.weight", "BF16", (D, F))]
    specs.append(("model.norm.weight", "BF16", (D,)))
    if not cfg["tie_word_embeddings"]:
        specs.append(("lm_head.weight", "BF16", (V, D)))
    return specs


def bert_tensor_specs(cfg: dict) -> list[tuple[str, str, tuple]]:
    """(name, dtype, shape) of a BertModel checkpoint's tensors (f32)."""
    D, F = cfg["hidden_size"], cfg["intermediate_size"]
    specs = [("embeddings.word_embeddings.weight", "F32", (cfg["vocab_size"], D)),
             ("embeddings.position_embeddings.weight", "F32",
              (cfg["max_position_embeddings"], D)),
             ("embeddings.token_type_embeddings.weight", "F32", (cfg["type_vocab_size"], D)),
             ("embeddings.LayerNorm.weight", "F32", (D,)),
             ("embeddings.LayerNorm.bias", "F32", (D,))]
    for i in range(cfg["num_hidden_layers"]):
        p = f"encoder.layer.{i}."
        for name, shape in (("attention.self.query", (D, D)), ("attention.self.key", (D, D)),
                            ("attention.self.value", (D, D)),
                            ("attention.output.dense", (D, D)),
                            ("attention.output.LayerNorm", None),
                            ("intermediate.dense", (F, D)), ("output.dense", (D, F)),
                            ("output.LayerNorm", None)):
            out = shape[0] if shape else D
            specs += [(p + name + ".weight", "F32", shape or (D,)),
                      (p + name + ".bias", "F32", (out,))]
    return specs


def _raw_bytes(t) -> memoryview:
    """The bytes of a CPU tensor, bf16 through an int16 view."""
    import torch
    t = t.contiguous().reshape(-1)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return memoryview(t.numpy()).cast("B")


def write_safetensors(path: str, specs: list, make) -> int:
    """Write one safetensors file by hand: an 8-byte little-endian header
    length, the JSON header (offsets from ``specs``), then each tensor's
    raw bytes as ``make(name, dtype, shape)`` returns it (a CPU tensor), one
    tensor in memory at a time. Returns the bytes written."""
    header, off = {}, 0
    for name, dt, shape in specs:
        n = math.prod(shape) * _ST_BYTES[dt]
        header[name] = {"dtype": dt, "shape": list(shape), "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for name, dt, shape in specs:
            t = make(name, dt, shape)
            if tuple(t.shape) != tuple(shape):
                raise RuntimeError(f"{name}: made {tuple(t.shape)}, declared {shape}")
            f.write(_raw_bytes(t))
    return 8 + len(raw) + off


def random_tensors(seed: int, device: str):
    """``make`` for ``write_safetensors``: seeded normal values (std 0.02,
    norm weights 1 + 0.02 N(0, 1)), drawn on ``device``, one generator per
    tensor name, returned on the CPU at the file's dtype."""
    import zlib

    import torch

    def make(name: str, dt: str, shape: tuple):
        g = torch.Generator(device=device).manual_seed(seed * 7919 + zlib.crc32(name.encode()))
        x = torch.randn(shape, generator=g, device=device) * 0.02
        if "norm" in name.lower() and name.endswith("weight"):
            x += 1.0
        return x.to(torch.bfloat16 if dt == "BF16" else torch.float32).cpu()
    return make


def write_sharded(out_dir: str, specs: list, make, shards: int) -> int:
    """``model-0000k-of-0000n.safetensors`` shards of about equal bytes in
    file order, and ``model.safetensors.index.json``. Returns the bytes."""
    sizes = [math.prod(s) * _ST_BYTES[d] for _, d, s in specs]
    total, per = sum(sizes), -(-sum(sizes) // shards)
    groups, acc = [[]], 0
    for spec, n in zip(specs, sizes):
        if acc >= per * len(groups) and len(groups) < shards:
            groups.append([])
        groups[-1].append(spec)
        acc += n
    weight_map, written = {}, 0
    for k, group in enumerate(groups, 1):
        fname = f"model-{k:05d}-of-{len(groups):05d}.safetensors"
        written += write_safetensors(os.path.join(out_dir, fname), group, make)
        weight_map.update((name, fname) for name, _, _ in group)
    with open(os.path.join(out_dir, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    return written


def train_bpe(texts, n_merges: int) -> tuple[dict, list]:
    """Byte-level BPE learned by a plain counting loop: the texts are
    NFC-normalized and split by the Qwen2 pre-tokenizer pattern, each piece
    mapped to the GPT-2 byte alphabet; then the most frequent adjacent pair
    (ties: the smallest pair) is merged everywhere, ``n_merges`` times or
    until no pair occurs twice. Returns (vocab: the 256 byte tokens, ids
    = byte values, then the merged tokens in merge order; merges)."""
    import collections
    import heapq
    import unicodedata

    from mediquery_rag_tpu_torch.models.bpe_tokenizer import (
        _QWEN2_PATTERN, _Splitter, bytes_to_unicode)

    enc = bytes_to_unicode()
    split = _Splitter(_QWEN2_PATTERN).split
    words = collections.Counter(
        "".join(enc[b] for b in piece.encode("utf-8"))
        for t in texts for piece in split(unicodedata.normalize("NFC", t)))
    vocab = {enc[b]: b for b in range(256)}
    seqs = {w: list(w) for w in words}
    pairs: collections.Counter = collections.Counter()
    where = collections.defaultdict(set)
    for w, n in words.items():
        for pair in zip(seqs[w], seqs[w][1:]):
            pairs[pair] += n
            where[pair].add(w)
    heap = [(-n, p) for p, n in pairs.items()]
    heapq.heapify(heap)
    merges = []
    while heap and len(merges) < n_merges:
        n, best = heapq.heappop(heap)
        if -n != pairs.get(best, 0):
            continue                     # a stale count: the current one is queued
        if -n < 2:
            break
        merged = best[0] + best[1]
        merges.append(best)
        vocab.setdefault(merged, len(vocab))
        touched = set()
        for w in where.pop(best):
            s, n_w = seqs[w], words[w]
            old = list(zip(s, s[1:]))
            new, i = [], 0
            while i < len(s):
                if i + 1 < len(s) and (s[i], s[i + 1]) == best:
                    new.append(merged)
                    i += 2
                else:
                    new.append(s[i])
                    i += 1
            seqs[w] = new
            for pair in old:
                pairs[pair] -= n_w
            for pair in zip(new, new[1:]):
                pairs[pair] += n_w
                where[pair].add(w)
            touched.update(old)
            touched.update(zip(new, new[1:]))
        for pair in touched:
            if pairs[pair] > 0:
                heapq.heappush(heap, (-pairs[pair], pair))
            else:
                pairs.pop(pair, None)
    return vocab, merges


def write_bpe_tokenizer(out_dir: str, texts, n_merges: int, specials: dict | None) -> int:
    """A Qwen2-structured ``tokenizer.json`` (NFC, the Qwen2 ``Split``
    pre-tokenizer, byte-level BPE from :func:`train_bpe`, ``specials`` as
    added tokens at their ids, or Qwen's three right after the vocabulary
    when None) and a ``tokenizer_config.json`` naming ``<|im_end|>`` as eos
    and ``<|endoftext|>`` as pad, as Qwen2.5-Instruct's. Returns one past
    the largest token id."""
    from mediquery_rag_tpu_torch.models.bpe_tokenizer import _QWEN2_PATTERN

    vocab, merges = train_bpe(texts, n_merges)
    if specials is None:
        specials = {s: len(vocab) + i for i, s in enumerate(QWEN_SPECIALS)}
    tj = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": s, "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False, "special": True}
                         for s, i in specials.items()],
        "normalizer": {"type": "NFC"},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": _QWEN2_PATTERN},
             "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False,
             "use_regex": False}]},
        "post_processor": None,
        "decoder": {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False,
                    "use_regex": False},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": "", "end_of_word_suffix": "",
                  "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                  "vocab": vocab, "merges": [list(m) for m in merges]},
    }
    with open(os.path.join(out_dir, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(tj, f, ensure_ascii=False)
    with open(os.path.join(out_dir, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump({"eos_token": "<|im_end|>", "pad_token": "<|endoftext|>",
                   "model_max_length": 131072}, f)
    return max([*vocab.values(), *specials.values()]) + 1


def write_wordpiece_vocab(out_dir: str, texts, size: int) -> None:
    """A bert-base-chinese-shaped ``vocab.txt``: [PAD], [unused1-99], [UNK],
    [CLS], [SEP], [MASK] at bert-base-chinese's ids, every character of
    ``texts`` (lowercased), a-z and 0-9 with their ``##`` pieces, padded with
    [unused] entries to ``size`` lines; and ``do_lower_case``."""
    fixed = (["[PAD]"] + [f"[unused{i}]" for i in range(1, 100)]
             + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"])
    alnum = "abcdefghijklmnopqrstuvwxyz0123456789"
    chars = sorted({ch for t in texts for ch in t.lower() if not ch.isspace()} | set(alnum))
    pieces = fixed + [c for c in chars if c not in fixed] + ["##" + c for c in alnum]
    if len(pieces) > size:
        raise ValueError(f"{len(pieces)} pieces do not fit a vocabulary of {size}")
    pieces += [f"[unused{i}]" for i in range(100, 100 + size - len(pieces))]
    with open(os.path.join(out_dir, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(pieces) + "\n")
    with open(os.path.join(out_dir, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump({"do_lower_case": True}, f)


def write_qwen2_checkpoint(out_dir: str, cfg: dict, texts, *, seed: int, device: str,
                           shards: int, merges: int = BPE_MERGES,
                           specials: dict | None = QWEN_SPECIALS) -> int:
    """An HF Qwen2 checkpoint directory written by hand: ``config.json``,
    seeded random bf16 weights in ``shards`` files, and the BPE tokenizer
    learned from ``texts`` (``specials`` as :func:`write_bpe_tokenizer`
    takes them). A ``vocab_size`` of None in ``cfg`` becomes the
    tokenizer's size plus 5 padding ids, which no token has (Qwen2.5-7B
    pads 151,665 tokens to 152,064 rows). Returns the bytes of the weights."""
    os.makedirs(out_dir, exist_ok=True)
    n_tokens = write_bpe_tokenizer(out_dir, texts, merges, specials)
    if cfg["vocab_size"] is None:
        cfg = dict(cfg, vocab_size=n_tokens + 5)
    if cfg["vocab_size"] < n_tokens:
        raise ValueError(f"vocab_size {cfg['vocab_size']} < the tokenizer's {n_tokens}")
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg, f, indent=1)
    return write_sharded(out_dir, qwen2_tensor_specs(cfg), random_tensors(seed, device),
                         shards)


def write_bert_checkpoint(out_dir: str, cfg: dict, texts, *, seed: int, device: str) -> int:
    """An HF BertModel checkpoint written by hand: ``config.json``, seeded
    random f32 weights in ``model.safetensors``, and a ``vocab.txt`` built
    from the characters of ``texts``. Returns the bytes written."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg, f, indent=1)
    write_wordpiece_vocab(out_dir, texts, cfg["vocab_size"])
    return write_safetensors(os.path.join(out_dir, "model.safetensors"),
                             bert_tensor_specs(cfg), random_tensors(seed, device))


HF_MAX_NEW = 48          # phase 9: the CLI client's reply budget (JAX's default is 256;
                         # cut for the run's time: random weights never stop early)
HF_SAMPLED = 64          # phase 9: checkpoint tensors held bit for bit on the card
HF_PARITY_STEPS = 8      # phase 9: decode steps of the 2-layer int8 model held to f32
HF_PHONE = "13800005555"
HF_ANSWERS = {           # phase 9: scripted answers by question key
    "name": "张三", "age": "45", "gender": "男", "height_cm": "175", "weight_kg": "80",
    "chronic": "无", "family_history": "无", "allergy": "无", "medication": "无",
    "chief_complaint": "最近两周经常头晕，偶尔胸闷", "duration": "两周", "severity": "4",
    "health_goal": "控制血压", "exercise": "每周快走三次", "sleep": "7"}
HF_QUERIES = QUESTIONS + ["感冒发烧怎么办", "儿童咳嗽用药", "胃痛", "BMI 如何计算？"]


def hf_slot(params: dict, name: str, qd: int, kvd: int):
    """The tensor of the port's decoder params that holds the checkpoint
    tensor ``name``, as HF stores it (``[out, in]``)."""
    if name == "model.embed_tokens.weight":
        return params["tok_embed"]
    if name == "lm_head.weight":
        return params["lm_head"].T
    if name == "model.norm.weight":
        return params["rms_f"]
    _, _, i, rest = name.split(".", 3)
    b, i = params["blocks"], int(i)
    qkv = {"q": slice(0, qd), "k": slice(qd, qd + kvd), "v": slice(qd + kvd, None)}
    if rest.startswith("self_attn.") and rest[10] in qkv and rest[11:17] == "_proj.":
        cols = qkv[rest[10]]
        return b["qkv_b"][i][cols] if rest.endswith("bias") else b["qkv"][i][:, cols].T
    return {"input_layernorm.weight": lambda: b["rms1"][i],
            "post_attention_layernorm.weight": lambda: b["rms2"][i],
            "self_attn.o_proj.weight": lambda: b["attn_out"][i].T,
            "mlp.gate_proj.weight": lambda: b["w_gate"][i].T,
            "mlp.up_proj.weight": lambda: b["w_up"][i].T,
            "mlp.down_proj.weight": lambda: b["w_down"][i].T}[rest]()


def check_sampled_tensors(torch, params: dict, cfg, model_dir: str, n: int) -> list:
    """``n`` tensors of the checkpoint, drawn with seed SEED, held bit for
    bit to the decoder params on the card. Returns their names."""
    import random

    from mediquery_rag_tpu_torch.models.hf_import import _load_all_tensors
    stored = _load_all_tensors(model_dir)
    names = random.Random(SEED).sample(sorted(stored), n)
    dh = cfg.hidden // cfg.heads
    for name in names:
        want = stored[name].load("cpu")
        got = hf_slot(params, name, cfg.heads * dh, cfg.kv_heads * dh).cpu()
        if got.dtype != want.dtype or not torch.equal(
                got.contiguous().view(torch.int16), want.view(torch.int16)):
            raise RuntimeError(f"9: {name} on the card differs from the checkpoint's bits")
    return names


class ScriptedUser:
    """``input()`` for ``cli.interface.main_menu``: one structured
    consultation (symptoms; a second one, on health management, if the
    first ended before a follow-up decision), one science question, then
    exit. Follow-up questions get "1" (an option's number, or a text)."""

    def __init__(self, followed_up):
        from mediquery_rag_tpu_torch.app.consultation import QUESTIONS as BANK
        self.by_text = {q.text: q.key for qs in BANK.values() for q in qs}
        self.followed_up = followed_up       # () -> whether a follow-up decision ran
        self.consults, self.asked = 0, []

    def __call__(self, prompt: str = "") -> str:
        if "请选择" in prompt:
            if self.consults == 0 or (self.consults == 1 and not self.followed_up()):
                self.consults += 1
                return "1"
            if not self.asked:
                return "2"
            return "q"
        if "手机号" in prompt:
            return HF_PHONE
        if "请提问" in prompt:
            if not self.asked:
                self.asked.append(HF_QUERIES[0])
                return HF_QUERIES[0]
            return "q"
        if prompt.startswith("🤖追问"):
            return "1"
        for text, key in self.by_text.items():
            if prompt.startswith(text):
                if key == "consult_type":
                    return "症状咨询" if self.consults == 1 else "健康管理"
                return HF_ANSWERS[key]
        raise RuntimeError(f"9: unexpected CLI prompt {prompt!r}")


def hf_cli(torch, results: dict, counters: list) -> dict:
    """Phase 9: the consultation CLI over an HF checkpoint of Qwen2.5-7B-
    Instruct's shape and a bert-base-chinese-shaped embedder, both written
    here by hand into a temporary directory that the phase deletes."""
    import builtins
    import contextlib
    import io
    import shutil
    import tempfile
    from dataclasses import replace

    from mediquery_rag_tpu_torch.cli import interface
    from mediquery_rag_tpu_torch.cli.context import AppContext
    from mediquery_rag_tpu_torch.config import EngineConfig
    from mediquery_rag_tpu_torch.ingest import build_document_store, parse_corpus_file
    from mediquery_rag_tpu_torch.llm import TorchLLMClient
    from mediquery_rag_tpu_torch.llm.torch_client import render_chat
    from mediquery_rag_tpu_torch.models import hf_import
    from mediquery_rag_tpu_torch.models.constrain import (
        EXTRACT_SCHEMA, FOLLOWUP_SCHEMA, RISK_SCHEMA)
    from mediquery_rag_tpu_torch.models.decoder import Decoder
    from mediquery_rag_tpu_torch.models.generate import Generator

    card = card_line()               # stands beside every number the phase prints
    corpus = os.path.join(ROOT, "data", "medical_data.txt")
    with open(corpus, encoding="utf-8") as f:
        lines = f.read().splitlines()
    chunks = [c.text for c in parse_corpus_file(corpus)]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="hf_cli_", dir=os.path.join(ROOT, "build"))
    env = {k: os.environ.get(k) for k in ("MEDIQUERY_HF_LLM", "MEDIQUERY_HF_LLM_QUANT",
                                          "MEDIQUERY_HF_LLM_KV", "MEDIQUERY_HF_EMBEDDER")}
    patched = (hf_import.load_qwen2, Generator.quantize_weights, builtins.input)
    out: dict = {}
    try:
        qspecs, bspecs = qwen2_tensor_specs(QWEN25_7B), bert_tensor_specs(BERT_BASE_ZH)
        need = sum(math.prod(s) * _ST_BYTES[d] for _, d, s in qspecs + bspecs)
        free = shutil.disk_usage(tmp).free
        log(f"9 disk: {free / 1e9:.2f} GB free under build/, the checkpoints take "
            f"{need / 1e9:.2f} GB  [{card}]")
        if free < need + (2 << 30):
            raise RuntimeError(f"9: {free / 1e9:.2f} GB free on disk, "
                               f"{need / 1e9 + 2:.2f} GB needed; the depth is not cut")
        qdir, bdir = os.path.join(tmp, "qwen"), os.path.join(tmp, "bert")
        t0 = time.perf_counter()
        qbytes = write_qwen2_checkpoint(qdir, QWEN25_7B, lines, seed=SEED, device=DEVICE,
                                        shards=4)
        t1 = time.perf_counter()
        bbytes = write_bert_checkpoint(bdir, BERT_BASE_ZH, lines, seed=SEED, device=DEVICE)
        out["write_s"] = {"qwen": t1 - t0, "bert": time.perf_counter() - t1}
        log(f"9 wrote the Qwen2.5-7B-shaped checkpoint ({qbytes / 1e9:.3f} GB in "
            f"{len([f for f in os.listdir(qdir) if f.endswith('.safetensors')])} shards, "
            f"{t1 - t0:.1f} s) and the bert-base-chinese-shaped one ({bbytes / 1e9:.3f} GB, "
            f"{out['write_s']['bert']:.1f} s)  [{card}]")

        # (b) the app on the card: load timed, 64 tensors held before quantizing
        timing: dict = {}

        def load_qwen2(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = patched[0](*a, **kw)
            torch.cuda.synchronize()
            timing["load_s"] = time.perf_counter() - t
            timing["peak_after_load_gb"] = torch.cuda.max_memory_allocated() / 1e9
            return res

        def quantize_weights(self, bits=8):
            if "checked" not in timing:
                timing["checked"] = check_sampled_tensors(torch, self.params, self.cfg, qdir,
                                                          HF_SAMPLED)
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = patched[1](self, bits)
            torch.cuda.synchronize()
            timing["quantize_s"] = time.perf_counter() - t
            return res

        hf_import.load_qwen2, Generator.quantize_weights = load_qwen2, quantize_weights
        os.environ.update({"MEDIQUERY_HF_LLM": qdir, "MEDIQUERY_HF_LLM_QUANT": "4",
                           "MEDIQUERY_HF_LLM_KV": "int8", "MEDIQUERY_HF_EMBEDDER": bdir})
        app = os.path.join(tmp, "app")
        os.makedirs(os.path.join(app, "data"))
        shutil.copy(corpus, os.path.join(app, "data", "medical_data.txt"))
        gc_cuda(torch)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        build_log = io.StringIO()
        with contextlib.redirect_stdout(build_log):
            ctx = AppContext.build(app, device=DEVICE)
        build_s = time.perf_counter() - t0
        hf_import.load_qwen2, Generator.quantize_weights = patched[:2]
        peak_build = torch.cuda.max_memory_allocated() / 1e9
        gen = ctx.llm.generator
        if not isinstance(ctx.llm, TorchLLMClient) or "q4" not in gen.params["lm_head"]:
            raise RuntimeError(f"9: AppContext did not serve the int4 HF model: {ctx.llm}")
        if type(ctx.embedder).__name__ != "BertTextEmbedder" or gen.cfg.kv_dtype != "int8":
            raise RuntimeError("9: AppContext did not take the HF embedder or the int8 cache")
        log(f"9 AppContext.build {build_s:.1f} s: load_qwen2 {timing['load_s']:.1f} s "
            f"(bf16 on the card, peak {timing['peak_after_load_gb']:.2f} GB), int4 quantize "
            f"{timing['quantize_s']:.2f} s, device memory peak {peak_build:.2f} GB; "
            f"{len(timing['checked'])} sampled tensors bit-equal to the checkpoint; "
            f"store {ctx.store.live_count} chunks x {ctx.store.index.corpus.shape[1]} "
            f"{ctx.store.index.corpus.dtype}  [{card}]")

        tok = gen.tokenizer
        bad = [t for t in chunks if tok.decode(tok.encode(t)) != t]
        if bad:
            raise RuntimeError(f"9: BPE decode(encode(t)) != t for {len(bad)} chunks")
        n_tok = sum(len(tok.encode(t)) for t in chunks)
        log(f"9 BPE ({len(tok.vocab)} tokens, eos {tok.eos_id}, pad {tok.pad_id}): "
            f"decode(encode(t)) == t for all {len(chunks)} chunks, "
            f"{n_tok / sum(len(t.encode()) for t in chunks):.3f} tokens per byte  [{card}]")

        # drive main_menu with scripted input, every LLM call recorded
        calls, prefill_s = [], []
        decode, prefill = gen._decode, gen.model.prefill

        def timed_prefill(*a, **kw):
            t = time.perf_counter()
            res = prefill(*a, **kw)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t)
            return res

        def timed_decode(prompts, max_new_tokens, temperature, seed, constraint):
            torch.cuda.synchronize()
            t = time.perf_counter()
            toks = decode(prompts, max_new_tokens, temperature, seed, constraint)
            dt = time.perf_counter() - t
            row = toks[0].tolist()
            steps = row.index(tok.eos_id) + 1 if tok.eos_id in row else len(row)
            calls.append({"constraint": constraint, "s": dt, "prefill_s": prefill_s[-1],
                          "steps": steps, "text": tok.decode(row).strip(),
                          "prompt_tokens": len(tok.encode(prompts[0]))})
            return toks

        fps = {json.dumps(s, sort_keys=True): name for name, s in (
            ("risk", RISK_SCHEMA), ("followup", FOLLOWUP_SCHEMA), ("extract", EXTRACT_SCHEMA))}

        def kinds():
            names = {c.fingerprint: fps[key] for key, c in ctx.llm._constraints.items()}
            return [names[c["constraint"].fingerprint] if c["constraint"] else "free"
                    for c in calls]

        gen._decode, gen.model.prefill = timed_decode, timed_prefill
        ctx.llm.max_new_tokens = HF_MAX_NEW
        user = ScriptedUser(lambda: "followup" in kinds())
        builtins.input = user
        transcript = io.StringIO()
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(transcript):
            interface.main_menu(ctx)
        drive_s = time.perf_counter() - t0
        launches = {fn.__name__.removesuffix("_cuda"): fn.launches for fn in counters}
        builtins.input = patched[2]
        gen._decode, gen.model.prefill = decode, prefill
        text = transcript.getvalue()
        log(f"9 main_menu {drive_s:.1f} s: {user.consults} consultation(s), "
            f"{len(user.asked)} science question(s), {len(calls)} LLM calls "
            f"{dict(collections.Counter(kinds()))}; launches {launches}  [{card}]")

        for kind, c in zip(kinds(), calls):
            if kind == "free":
                continue
            try:
                json.loads(c["text"])
            except ValueError as e:
                raise RuntimeError(f"9: a {kind} reply is not JSON: {c['text']!r}") from e
            if not c["constraint"].accepts(c["text"]):
                raise RuntimeError(f"9: a {kind} reply breaks its schema: {c['text']!r}")
        missing = [k for k in ("risk", "followup") if k not in kinds()]
        if missing or "再见" not in text or "检索到" not in text or not user.asked:
            raise RuntimeError(f"9: the CLI run missed {missing or 'its RAG answer or exit'}")
        need = ("flat_topk", "matvec_int4", "flash_prefill", "flash_decode_int8")
        if any(launches.get(n, 0) <= 0 for n in need):
            raise RuntimeError(f"9: kernels not launched by the CLI path: {launches}")

        def rate(sel):
            sel = [c for c in calls if sel(c)]
            steps = sum(c["steps"] for c in sel)
            step_s = sum(c["s"] - c["prefill_s"] for c in sel)
            prefill = sorted(c["prefill_s"] for c in sel[1:]) or [0.0]
            return {"calls": len(sel), "tokens": steps, "s": sum(c["s"] for c in sel),
                    "ms_per_step": 1e3 * step_s / max(steps - len(sel), 1),
                    "decode_tok_per_s": (steps - len(sel)) / max(step_s, 1e-9),
                    "first_prefill_s": sel[0]["prefill_s"] if sel else 0.0,
                    "prefill_ms_median": 1e3 * prefill[len(prefill) // 2],
                    "prompt_tokens": [c["prompt_tokens"] for c in sel]}
        free_r = rate(lambda c: c["constraint"] is None)
        con_r = rate(lambda c: c["constraint"] is not None)
        log(f"9 answers (free, {free_r['calls']} calls of {HF_MAX_NEW} tokens, prompts "
            f"{free_r['prompt_tokens']} tokens): {free_r['ms_per_step']:.2f} host ms per decode "
            f"step, {free_r['decode_tok_per_s']:.2f} tok/s decoding; prefill {free_r['first_prefill_s']:.2f} s "
            f"for the first call of the run (first use), then median {free_r['prefill_ms_median']:.1f} ms; "
            f"constrained ({con_r['calls']} calls, every reply parsed under its schema): "
            f"{con_r['tokens']} tokens, {con_r['ms_per_step']:.2f} host ms per constrained step "
            f"({con_r['ms_per_step'] - free_r['ms_per_step']:+.2f} ms against a free step: the "
            f"DFA walk over {gen.cfg.vocab_size} tokens)  [{card}]")
        peak_all = torch.cuda.max_memory_allocated() / 1e9

        # the BERT store's top-10 against the port's plain path on the CPU
        t0 = time.perf_counter()
        cpu_emb = hf_import.BertTextEmbedder.from_hf(bdir, device="cpu")
        cpu_store = build_document_store(corpus, cpu_emb, EngineConfig(), device="cpu")
        cpu_s = time.perf_counter() - t0
        got = ctx.store.batch_search(HF_QUERIES, k=20)
        want = cpu_store.batch_search(HF_QUERIES, k=20)
        dev, differ = 0.0, 0
        for g, w in zip(got, want):
            ws = {d.text: d.score for d in w}
            dev = max([dev] + [abs(d.score - ws[d.text]) for d in g if d.text in ws])
        for g, w in zip(got, want):
            gk, wk = g[:10], w[:10]
            differ += len({d.text for d in gk} ^ {d.text for d in wk}) // 2
            if not _row_ties_only([d.score for d in gk], [d.text for d in gk],
                                  [d.score for d in wk], [d.text for d in wk], 2 * dev):
                raise RuntimeError("9: the BERT store's top-10 differs from the CPU's "
                                   f"beyond ties (score deviation {dev:.2e})")
        log(f"9 BERT store top-10 of {len(HF_QUERIES)} queries held to the CPU's plain path "
            f"(built in {cpu_s:.1f} s): {differ} ids swapped, all within ties of twice the "
            f"largest card-CPU score deviation {dev:.2e}  [{card}]")
        out.update(build_s=build_s, drive_s=drive_s, peak_build_gb=peak_build,
                   peak_gb=peak_all, free=free_r, constrained=con_r, launches=launches,
                   bert_top10={"score_dev": dev, "swapped": differ},
                   calls=[{k: v for k, v in c.items() if k != "constraint"} | {"kind": k}
                          for c, k in zip(calls, kinds())],
                   transcript=text[-20000:], **{k: v for k, v in timing.items()
                                                 if k != "checked"})
        del ctx, gen, cpu_store, cpu_emb
        gc_cuda(torch)

        # the 7B-width int8 model at 2 layers against the same in f32 on the CPU
        q2 = os.path.join(tmp, "qwen_2layers")
        os.makedirs(q2)
        for f in os.listdir(qdir):
            if f != "config.json":
                os.symlink(os.path.join(qdir, f), os.path.join(q2, f))
        with open(os.path.join(q2, "config.json"), "w") as f:
            json.dump(dict(QWEN25_7B, num_hidden_layers=2), f)
        on_card = TorchLLMClient.from_hf(q2, quantize=8, device=DEVICE).generator
        cpu = TorchLLMClient.from_hf(q2, quantize=8, device="cpu").generator
        models = {"card": on_card.model, "cpu": cpu.model,
                  "f32": Decoder(replace(cpu.cfg, dtype="float32"), cpu.params)}
        ids, mask = cpu.tokenizer.batch_encode([render_chat(QUESTIONS[0], template="chatml")])
        par = parity_walk(torch, models, torch.from_numpy(ids), torch.from_numpy(mask),
                          ids.shape[1] + 128, HF_PARITY_STEPS, f"9 int8 HF 2-layer [{card}]")
        ratio = par["card"] / par["cpu"]
        log(f"9 int8 HF model, 2 layers at 7B widths (vocab {cpu.cfg.vocab_size}): worst vs "
            f"f32 card {par['card']:.3e}, cpu bf16 {par['cpu']:.3e}, ratio {ratio:.3f} (limit "
            f"{DECODER_RATIO}); greedy token held to f32's at {par['checked']} of "
            f"{HF_PARITY_STEPS + 1} positions (the rest are near ties over 152,064 random "
            f"logits), the card's token beyond a near tie at {par['far']}  [{card}]")
        if ratio > DECODER_RATIO or par["far"]:
            raise RuntimeError(f"9: the int8 HF model on the card strays from f32: {par}")
        out["int8_2layer"] = dict(par, ratio=ratio)
        del on_card, cpu, models
    finally:
        hf_import.load_qwen2, Generator.quantize_weights, builtins.input = patched
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
        gc_cuda(torch)
    out["card"] = card
    results["hf_cli"] = out
    return out["launches"]


# Phase 10's rules, written down before its first run on the card:
C7_SHAPE = (4096, 3584, 18944)   # 10a: a 7B prefill's gate projection (rows, in, out)
C7_STEPS = 4             # 10a: decode steps of the float-weight bf16 decoder walk
EMBED_COS_MIN = 0.999    # 10b: per-row cosine of the card's 12-layer bf16 embeddings
                         # with the port's on the CPU (both round to bf16 at the same
                         # casts; f32 sums in another order flip a bf16 neighbour now
                         # and then, and 12 layers carry it on)
HYBRID_TIE = 5e-3        # 10c: a top-10 id only one store returns scores within this
                         # of the other's 10th (fused score: 0.1 x the semantic cosine)
GRADER_LOGIT_TOL = 2e-2  # 10d: |card - CPU| of the 2-layer bf16 grader's logits
TRAIN_LOSS_REL = 1e-2    # 10e: the first contrastive step's loss, card vs CPU (relative)
ENC_QUERIES = ["高血压患者平时饮食需要注意什么？", "糖尿病的早期症状有哪些？",
               "孕妇可以吃感冒药吗", "头痛发烧怎么办", "老年人如何补钙"]


def _events_ms(torch, fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` back-to-back launches (CUDA events,
    after a warm-up)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queue_c7(torch, out: dict, card: str, ratio4: float) -> None:
    """10a: the f32-sum product of bf16 operands (``ops.matmul.mm_f32``,
    cuBLAS through ``aten::mm.dtype``) at a 7B prefill shape against an f64
    product of the same rounded operands, per element within the f32
    sum-order bound K 2^-24 sum|a w|; its time beside the bf16-output
    product and the f32 SGEMM (TF32 off); phase 4's bf16 ratio; and a
    2-layer 7B-width decoder with bf16 FLOAT weights (every projection
    through the helper, prefill past 128 rows) on the card and on the CPU,
    held to f32 on the CPU by phase 4's rule."""
    from dataclasses import replace

    from mediquery_rag_tpu_torch.models.decoder import Decoder, init_params
    from mediquery_rag_tpu_torch.ops.matmul import mm_f32

    M, K, N = C7_SHAPE
    bf = torch.bfloat16
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    a = torch.randn((M, K), generator=gen, device=DEVICE).to(bf)
    w = (torch.randn((K, N), generator=gen, device=DEVICE) * K ** -0.5).to(bf)
    got = mm_f32(a, w, bf)
    err = (got.double() - a.double() @ w.double()).abs()
    bound = K * 2.0 ** -24 * mm_f32(a.abs(), w.abs(), bf).double()
    over = int((err > bound).sum())
    af, wf = a.float(), w.float()
    ms = {"mm_f32": _events_ms(torch, lambda: mm_f32(a, w, bf), 20),
          "bf16_out": _events_ms(torch, lambda: a @ w, 20),
          "f32_sgemm": _events_ms(torch, lambda: af @ wf, 5)}
    tflops = {k: 2 * M * K * N / v / 1e9 for k, v in ms.items()}
    out["c7_gemm"] = {"shape": C7_SHAPE, "max_abs_err": err.max().item(),
                      "max_err_over_bound": (err / bound).max().item(), "over_bound": over,
                      "ms": ms, "tflops": tflops}
    log(f"10a mm_f32 {M}x{K} @ {K}x{N} vs f64 of the rounded operands: max|err| "
        f"{err.max().item():.3e}, max err/bound {(err / bound).max().item():.3f}, "
        f"{over} over; ms mm_f32 {ms['mm_f32']:.4f} ({tflops['mm_f32']:.0f} TFLOP/s), "
        f"bf16 out {ms['bf16_out']:.4f}, f32 SGEMM {ms['f32_sgemm']:.4f}  [{card}]")
    del a, w, got, err, bound, af, wf
    if over:
        raise RuntimeError(f"10a: mm_f32 misses the f32 sum-order bound at {over} elements")
    out["phase4_ratio"] = ratio4
    cfg = qwen7b_config(layers=2)
    params = init_params(cfg, seed=SEED, device=DEVICE)
    cpu_params = _to(params, "cpu")
    params = _to(params, DEVICE)
    models = {"card": Decoder(cfg, params), "cpu": Decoder(cfg, cpu_params),
              "f32": Decoder(replace(cfg, dtype="float32"), cpu_params)}
    g = torch.Generator().manual_seed(SEED)
    S = 160
    ids = torch.randint(3, 259, (1, S), generator=g)
    mask = torch.ones((1, S))
    mask[:, :9] = 0
    par = parity_walk(torch, models, ids, mask, 256, C7_STEPS, "10a float bf16 decoder")
    ratio = par["card"] / par["cpu"]
    out["float_decoder"] = dict(par, ratio=ratio)
    log(f"10a float-weight bf16 decoder (2 layers, 7B widths, prefill {S} rows): vs f32 "
        f"card {par['card']:.3e}, cpu bf16 {par['cpu']:.3e}, ratio {ratio:.3f} (limit "
        f"{DECODER_RATIO}); phase 4's int8 ratio {ratio4:.3f}  [{card}]")
    if ratio > DECODER_RATIO:
        raise RuntimeError(f"10a: the float bf16 decoder on the card strays from f32: {ratio}")
    del models, params, cpu_params


def encoder_card(torch, out: dict, app: str, card: str):
    """10b: a full-width ``TextEmbedder`` (``EmbedderConfig()``, seeded
    weights on the card): save -> from_checkpoint bit-equal, the corpus
    chunks embedded at the ingest batch against the port on the CPU (per-row
    cosine >= EMBED_COS_MIN), host ms per query at B=1 and chunks/s.
    Returns the CPU embeddings by text."""
    import numpy as np

    from mediquery_rag_tpu_torch.config import EmbedderConfig
    from mediquery_rag_tpu_torch.ingest import parse_corpus_file
    from mediquery_rag_tpu_torch.models import TextEmbedder, optim

    te = TextEmbedder(EmbedderConfig(), generator=torch.Generator(device=DEVICE).manual_seed(
        SEED), device=DEVICE)
    ckpt = os.path.join(app, "checkpoints", "embedder")
    te.save(ckpt)
    back = TextEmbedder.from_checkpoint(ckpt, device=DEVICE)
    same = all(torch.equal(x, y) for x, y in zip(optim.tree_leaves(te.params),
                                                   optim.tree_leaves(back.params)))
    if not same:
        raise RuntimeError("10b: the reloaded checkpoint differs on the card")
    texts = [c.text for c in parse_corpus_file(os.path.join(ROOT, "data", "medical_data.txt"))]

    def embed_all(emb):
        return np.concatenate([emb.embed(texts[i:i + 64]) for i in range(0, len(texts), 64)])

    embed_all(back)
    t0 = time.perf_counter()
    on_card = embed_all(back)
    ingest_s = time.perf_counter() - t0
    q_ms = []
    for q in ENC_QUERIES * 4:
        t = time.perf_counter()
        back.embed([q])
        q_ms.append((time.perf_counter() - t) * 1e3)
    cpu = TextEmbedder.from_checkpoint(ckpt, device="cpu")
    t0 = time.perf_counter()
    on_cpu = embed_all(cpu)
    cpu_s = time.perf_counter() - t0
    cos = (on_card * on_cpu).sum(1)
    out["embedder"] = {"bit_equal_reload": same, "chunks": len(texts),
                       "chunks_per_s": len(texts) / ingest_s, "query_ms_b1": sorted(q_ms),
                       "query_ms_b1_median": float(np.median(q_ms)), "cpu_s": cpu_s,
                       "cos_min": float(cos.min()), "cos_mean": float(cos.mean()),
                       "max_abs": float(np.abs(on_card - on_cpu).max())}
    c = te.cfg
    log(f"10b TextEmbedder ({c.layers} x {c.hidden}, {c.dtype}): reload bit-equal; {len(texts)} chunks at batch "
        f"64: {len(texts) / ingest_s:.1f} chunks/s; B=1 query {np.median(q_ms):.2f} host ms "
        f"(median of {len(q_ms)}); vs the CPU ({cpu_s:.1f} s): per-row cosine min "
        f"{cos.min():.6f} mean {cos.mean():.6f} (limit {EMBED_COS_MIN}), max|d| "
        f"{np.abs(on_card - on_cpu).max():.3e}  [{card}]")
    if cos.min() < EMBED_COS_MIN or not np.isfinite(on_card).all():
        raise RuntimeError(f"10b: card embeddings stray from the CPU's: {cos.min()}")
    return dict(zip(texts, on_cpu)), cpu


def hybrid_app(torch, out: dict, app: str, card: str, counters: list, cache: dict,
               cpu_te) -> int:
    """10c: ``AppContext.build`` with ``MEDIQUERY_HYBRID=1`` over 10b's
    checkpoint on the card: a ``HybridEmbedder`` store (B1 launches
    counted over its search), graded by ``SimilarityGrader`` at 0.2, its
    top-10 held to the same hybrid store built on the CPU (10b's CPU
    embeddings) but for near ties. Returns B1's launches."""
    import contextlib
    import io

    import numpy as np

    from mediquery_rag_tpu_torch.cli.context import AppContext
    from mediquery_rag_tpu_torch.ingest import build_document_store
    from mediquery_rag_tpu_torch.models import HybridEmbedder
    from mediquery_rag_tpu_torch.models.cross_encoder import SimilarityGrader

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        ctx = AppContext.build(app, fake_llm=True, device=DEVICE)
    build_s = time.perf_counter() - t0
    if not (isinstance(ctx.embedder, HybridEmbedder) and isinstance(
            ctx.grade_fn, SimilarityGrader) and ctx.grade_fn.threshold == 0.2):
        raise RuntimeError(f"10c: not the hybrid app: {type(ctx.embedder).__name__}, "
                           f"{type(ctx.grade_fn).__name__}")
    width = ctx.store.index.corpus.shape[1]
    for fn in counters:
        fn.launches = 0
    hits = ctx.store.batch_search(ENC_QUERIES, k=10)
    b1 = counters[0].launches

    def sem_cpu(texts):
        return np.stack([cache[t] if t in cache else cpu_te.embed([t])[0] for t in texts])

    cpu_store = build_document_store(os.path.join(app, "data", "medical_data.txt"),
                                     HybridEmbedder(ctx.embedder.lexical, sem_cpu, w_lex=0.9),
                                     device="cpu")
    ref = cpu_store.batch_search(ENC_QUERIES, k=10)

    row = {c.chunk_id: i for i, c in enumerate(cpu_store.chunks)}

    def rows(res):
        return (torch.tensor([[d.score for d in r] for r in res]),
                torch.tensor([[row[d.metadata["chunk_id"]] for d in r] for r in res]))

    (ks, ki), (ps, pi) = rows(hits), rows(ref)
    exact = int((ki == pi).all(1).sum())
    ok = _ties_only(ks, ki, ps, pi, HYBRID_TIE)
    out["hybrid"] = {"build_s": build_s, "width": width, "b1_launches": b1,
                     "queries_exact": exact, "ties_only": ok,
                     "max_score_diff": float((ks - ps).abs().max())}
    log(f"10c hybrid AppContext on the card ({build_s:.1f} s): {ctx.store.live_count} chunks "
        f"at {width} dims, SimilarityGrader 0.2; B1 launches {b1} over {len(ENC_QUERIES)} "
        f"queries; top-10 vs the CPU store: {exact}/{len(ENC_QUERIES)} identical, near ties "
        f"only {ok}, max |dscore| {(ks - ps).abs().max().item():.3e}  [{card}]")
    if b1 < 1 or not ok:
        raise RuntimeError(f"10c: hybrid search: B1 launches {b1}, ties only {ok}")
    return b1


def grader_app(torch, out: dict, app: str, card: str, counters: list) -> int:
    """10d: ``train_grader`` at its defaults for one epoch on the card,
    saved as a ``TrainedGrader``; the CLI's context loads it and answers one
    /qa graph run with the scripted LLM through it; its logits on the card
    against the same checkpoint on the CPU. Returns B1's launches."""
    import contextlib
    import io

    import numpy as np

    from mediquery_rag_tpu_torch.cli.context import AppContext
    from mediquery_rag_tpu_torch.ingest import parse_corpus_file
    from mediquery_rag_tpu_torch.llm.messages import user
    from mediquery_rag_tpu_torch.models import train_grader
    from mediquery_rag_tpu_torch.models.cross_encoder import TrainedGrader, score_pairs

    corpus = os.path.join(app, "data", "medical_data.txt")
    gdir = os.path.join(app, "checkpoints", "grader")
    log_ = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log_):
        train_grader.main(["--corpus", corpus, "--out", gdir, "--epochs", "1",
                           "--device", DEVICE])
    train_s = time.perf_counter() - t0
    final = [ln for ln in log_.getvalue().splitlines() if ln.startswith("final loss")]
    with contextlib.redirect_stdout(io.StringIO()):
        ctx = AppContext.build(app, fake_llm=True, device=DEVICE)
    if not isinstance(ctx.grade_fn, TrainedGrader):
        raise RuntimeError(f"10d: grade_fn is {type(ctx.grade_fn).__name__}")
    calls = [0]
    inner = ctx.grade_fn._grade

    def counted(q, docs):
        calls[0] += 1
        return inner(q, docs)

    ctx.grade_fn._grade = counted
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    events = list(ctx.graph_app.stream({"messages": [user(ENC_QUERIES[0])],
                                        "user_id": "anonymous"}, thread_id="p10"))
    qa_s = time.perf_counter() - t0
    b1 = counters[0].launches
    answer = events[-1][1].get("final_answer", "")
    chunks = parse_corpus_file(corpus)[:16]
    qs, ds = [c.title for c in chunks], [c.content for c in chunks]
    g = ctx.grade_fn
    on_card = score_pairs(g.params, g.cfg, qs, ds)
    cpu = TrainedGrader.from_checkpoint(gdir, device="cpu")
    on_cpu = score_pairs(cpu.params, cpu.cfg, qs, ds)
    dmax = float(np.abs(on_card - on_cpu).max())
    out["grader"] = {"train_s": train_s, "final_loss": final, "qa_s": qa_s,
                     "grade_calls": calls[0], "b1_launches": b1, "logit_max_diff": dmax,
                     "logit_range": [float(on_cpu.min()), float(on_cpu.max())]}
    log(f"10d train_grader (1 epoch at its defaults) {train_s:.1f} s, {final}; /qa through "
        f"the TrainedGrader ({calls[0]} grade calls, B1 launches {b1}) {qa_s:.2f} s; logits "
        f"card vs CPU over 16 pairs: max|d| {dmax:.3e} (limit {GRADER_LOGIT_TOL}), range "
        f"[{on_cpu.min():.3f}, {on_cpu.max():.3f}]  [{card}]")
    if not answer or calls[0] < 1 or b1 < 1 or dmax > GRADER_LOGIT_TOL:
        raise RuntimeError(f"10d: answer {bool(answer)}, grade calls {calls[0]}, B1 {b1}, "
                           f"logit diff {dmax}")
    return b1


def contrastive_card(torch, out: dict, card: str) -> None:
    """10e: ``ContrastiveTrainer`` at ``EmbedderConfig()``, batch 8 (the
    train entry's default), ``remat=True``, 10 steps over the corpus pairs:
    ms per step, tokens/s, MFU over 989 TFLOP/s (model FLOPs: 6 x block
    params x tokens + 12 L S^2 D per sequence for attention), peak memory,
    the loss finite at every step and the first step's loss against the
    port on the CPU (forward only)."""
    from mediquery_rag_tpu_torch.config import EmbedderConfig, TrainConfig
    from mediquery_rag_tpu_torch.ingest import parse_corpus_file
    from mediquery_rag_tpu_torch.models import HashCharTokenizer
    from mediquery_rag_tpu_torch.models.data import PairLoader, pairs_from_chunks
    from mediquery_rag_tpu_torch.models.embedder import BLOCK_KEYS, trainable
    from mediquery_rag_tpu_torch.models.trainer import ContrastiveTrainer

    cfg = EmbedderConfig()
    tcfg = TrainConfig(batch_size=8, lr=1e-4, warmup_steps=20)
    pairs = pairs_from_chunks(parse_corpus_file(os.path.join(ROOT, "data",
                                                             "medical_data.txt")))
    loader = PairLoader(pairs, HashCharTokenizer(cfg.vocab_size, cfg.max_len), 8, seed=SEED)
    batches = [b for b, _ in zip(loader.batches(epochs=1), range(10))]
    tr = ContrastiveTrainer(cfg, tcfg, device=DEVICE)
    state = tr.init_state(torch.Generator(device=DEVICE).manual_seed(SEED))
    first = trainable(state.params, "cpu")        # copies: the steps update in place
    gc_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for b in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = tr.train_step(state, b)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    block_params = sum(getattr(tr.model(state.params), k).numel() for k in BLOCK_KEYS)
    flops, tokens = [], []
    for b in batches:
        n = sum(t.numel() for t in (b.q_ids, b.d_ids))
        attn = sum(12 * cfg.layers * t.shape[0] * t.shape[1] ** 2 * cfg.hidden
                   for t in (b.q_ids, b.d_ids))
        tokens.append(n)
        flops.append(6 * block_params * n + attn)
    steady = ms[1:]
    step_ms = sum(steady) / len(steady)
    tok_s = sum(tokens[1:]) / (sum(steady) / 1e3)
    mfu = sum(flops[1:]) / (sum(steady) / 1e3) / PEAK_OPS["bf16"]
    cpu_tr = ContrastiveTrainer(cfg, TrainConfig(batch_size=8, lr=1e-4, warmup_steps=20,
                                                 remat=False), device="cpu")
    with torch.no_grad():
        cpu_loss = float(cpu_tr.loss(first, batches[0]))
    rel = abs(losses[0] - cpu_loss) / abs(cpu_loss)
    out["contrastive"] = {"ms": ms, "step_ms": step_ms, "tokens_per_s": tok_s, "mfu": mfu,
                          "peak_gb": peak, "losses": losses, "cpu_first_loss": cpu_loss,
                          "first_loss_rel": rel, "padded_tokens_per_step": tokens,
                          "block_params": block_params}
    log(f"10e ContrastiveTrainer {cfg.layers} x {cfg.hidden}, B=8, remat: {step_ms:.1f} ms/step (steps 2-10; "
        f"first {ms[0]:.0f}), {tok_s:.0f} padded tokens/s, MFU {mfu * 100:.2f}% of 989 "
        f"TFLOP/s, peak {peak:.2f} GB; losses {[round(x, 4) for x in losses]}; first loss "
        f"card {losses[0]:.5f} vs CPU {cpu_loss:.5f} (rel {rel:.2e}, limit "
        f"{TRAIN_LOSS_REL})  [{card}]")
    if not all(math.isfinite(x) for x in losses) or rel > TRAIN_LOSS_REL:
        raise RuntimeError(f"10e: losses {losses}, first-step rel {rel}")
    del state, tr, first


def encoders(torch, results: dict, counters: list) -> dict:
    """Phase 10: Queue C 7's repair on the card and the encoders, the
    hybrid store and the trained grader behind the CLI's context, in a
    temporary app directory under ``build/`` (deleted after)."""
    import shutil
    import tempfile

    card = card_line()
    out: dict = {"card": card}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="p10_", dir=os.path.join(ROOT, "build"))
    app = os.path.join(tmp, "app")
    os.makedirs(os.path.join(app, "data"))
    shutil.copy(os.path.join(ROOT, "data", "medical_data.txt"),
                os.path.join(app, "data", "medical_data.txt"))
    env = {k: os.environ.get(k) for k in ("MEDIQUERY_HYBRID", "MEDIQUERY_HF_EMBEDDER",
                                          "MEDIQUERY_HF_LLM", "MEDIQUERY_INDEX")}
    seconds: dict = {}
    try:
        for k in env:
            os.environ.pop(k, None)
        os.environ["MEDIQUERY_HYBRID"] = "1"
        t = time.perf_counter()
        queue_c7(torch, out, card, results["decoder_parity"]["ratio"])
        gc_cuda(torch)
        seconds["10a"], t = time.perf_counter() - t, time.perf_counter()
        cache, cpu_te = encoder_card(torch, out, app, card)
        seconds["10b"], t = time.perf_counter() - t, time.perf_counter()
        b1 = hybrid_app(torch, out, app, card, counters, cache, cpu_te)
        seconds["10c"], t = time.perf_counter() - t, time.perf_counter()
        b1 += grader_app(torch, out, app, card, counters)
        seconds["10d"], t = time.perf_counter() - t, time.perf_counter()
        gc_cuda(torch)
        contrastive_card(torch, out, card)
        seconds["10e"] = time.perf_counter() - t
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
        gc_cuda(torch)
    out["seconds"] = seconds
    log(f"10 seconds per part { {k: round(v, 1) for k, v in seconds.items()} }  [{card}]")
    results["encoders"] = out
    return {"flat_topk": b1}


def main() -> int:
    sys.modules["jax"] = None                  # the port must run without JAX
    sys.modules["mediquery_rag_tpu"] = None    # and without the JAX package
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from mediquery_rag_tpu_torch.ops import (
        _build, attention, ivf_kernel, matvec, quant, scoring)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results: dict = {"phase_s": {}}
    card = card_line()
    log(f"card: {card}")

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        results["phase_s"][name] = dt = time.perf_counter() - t0
        log(f"phase {name}: {dt:.2f} s")
        return out

    built = phase("2 build", _build.build_all)
    log(f"kernel build: nvcc per library { {k: round(v, 2) for k, v in built.items()} }")
    results["build_s"] = built
    table = phase("3 kernels", compare_kernels, torch, results)
    phase("3b quant kernels", compare_quant_kernels, torch, results, table)
    ivf_idx = phase("3c IVF kernels", compare_ivf_kernels, torch, results, table)
    sharded_launches = phase("11 sharded retrieval", sharded_retrieval, torch, results,
                             ivf_idx, card)
    del ivf_idx
    torch.cuda.empty_cache()
    phase("3d LLM kernels", compare_llm_kernels, torch, results, table)
    phase("4 decoder parity", decoder_parity, torch, results)
    phase("4b int4 + int8-KV decoder parity", decoder_parity_int4, torch, results)
    counters = [scoring.flat_topk_cuda, matvec.matvec_int8_cuda,
                attention.flash_prefill_cuda, attention.flash_decode_cuda]
    gen, store = phase("5 serve", serve, torch, results, counters)
    launches = dict(results["launches"])
    llm_counters = [matvec.matvec_int4_cuda, attention.flash_decode_int8_cuda,
                    attention.flash_prefill_int8_cuda]
    llm_launches, target, nodraft = phase("5b LLM serving", serve_llm, torch, results,
                                          counters + llm_counters, store)
    launches.update({fn.__name__.removesuffix("_cuda"): llm_launches[
        fn.__name__.removesuffix("_cuda")] for fn in llm_counters})
    spec_counters = [attention.flash_decode_ml_cuda, attention.flash_dq_cuda,
                     attention.flash_dkv_cuda]
    spec_launches = phase("5c speculative serving", serve_spec, torch, results,
                          counters + llm_counters + spec_counters, store, target, nodraft,
                          table)
    launches["flash_decode_ml"] = spec_launches["flash_decode_ml"]
    del store, target
    torch.cuda.empty_cache()
    rows = store_rows()
    counters += [quant.int8_topk_cuda, quant.int4_topk_cuda]
    quant_launches = phase("6 quantized serving", serve_quantized, torch, results,
                           counters, rows)
    launches.update({name: quant_launches[name] for name in ("int8_topk", "int4_topk")})
    ivf_counters = [ivf_kernel.ivf_probe_topk_cuda, ivf_kernel.ivf_probe_topk_f32_cuda,
                    ivf_kernel.ivf_probe_topk_int8_cuda, ivf_kernel.ivf_probe_topk_int4_cuda,
                    ivf_kernel.ivf_batch_topk_cuda, ivf_kernel.ivf_batch_topk_f32_cuda,
                    ivf_kernel.ivf_batch_topk_int8_cuda, ivf_kernel.ivf_batch_topk_int4_cuda]
    ivf_launches = phase("6b IVF serving", serve_ivf, torch, results,
                         counters + ivf_counters, rows)
    launches.update({fn.__name__.removesuffix("_cuda"): ivf_launches[
        fn.__name__.removesuffix("_cuda")] for fn in ivf_counters})
    del rows
    stream_launches = phase("6c streaming tiers", streaming_tiers, torch, results,
                            counters + ivf_counters + [scoring.flat_topk_f32_cuda])
    launches["flat_topk_f32"] = stream_launches["flat_topk_f32"]
    phase("7 decode", decode_rate, torch, gen, results)
    del gen
    torch.cuda.empty_cache()
    train_launches = phase("8 training", training, torch, results, table)
    launches.update({n: train_launches[n] for n in ("flash_dq", "flash_dkv")})
    gc_cuda(torch)
    mesh_launches = phase("12 distributed training", distributed_training, torch, results,
                          card)
    for name, n in mesh_launches.items():     # the mesh runs' own launches, every rank's
        launches[name] += n
    gc_cuda(torch)
    tp_launches = phase("13 TP generation", tp_generation, torch, results, card)
    for name, n in tp_launches.items():       # every rank's launches over the model axis
        launches[name] += n
    gc_cuda(torch)
    hf_counters = [scoring.flat_topk_cuda, matvec.matvec_int4_cuda, matvec.matvec_int8_cuda,
                   attention.flash_prefill_cuda, attention.flash_prefill_int8_cuda,
                   attention.flash_decode_cuda, attention.flash_decode_int8_cuda]
    hf_launches = phase("9 HF CLI", hf_cli, torch, results, hf_counters)
    for name, n in hf_launches.items():     # the CLI's path adds its own launches
        launches[name] += n
    enc_launches = phase("10 encoders", encoders, torch, results, [scoring.flat_topk_cuda])
    launches["flat_topk"] += enc_launches["flat_topk"]
    for name, n in sharded_launches.items():     # the sharded path's own launches
        launches[name] += n

    ivf_src = ("ivf_topk.cu", "mediquery_rag_tpu/ops/ivf_kernel.py:")
    sources = {     # kernel -> (CUDA source, the TPU kernel it replaces)
        "flat_topk": ("flat_topk.cu", "mediquery_rag_tpu/ops/scoring.py:303"),
        "flat_topk_f32": ("flat_topk.cu", "mediquery_rag_tpu/ops/scoring.py:303"),
        "matvec_int8": ("matvec_int8.cu", "mediquery_rag_tpu/ops/matvec.py:30"),
        "flash_prefill": ("flash_prefill.cu", "mediquery_rag_tpu/ops/attention.py:72"),
        "flash_decode": ("flash_decode.cu", "mediquery_rag_tpu/ops/attention.py:171"),
        "int8_topk": ("quant_topk.cu", "mediquery_rag_tpu/ops/quant.py:43"),
        "int4_topk": ("quant_topk.cu", "mediquery_rag_tpu/ops/quant.py:220"),
        "ivf_probe_topk": (ivf_src[0], ivf_src[1] + "30"),
        "ivf_probe_topk_f32": (ivf_src[0], ivf_src[1] + "30"),
        "ivf_probe_topk_int8": (ivf_src[0], ivf_src[1] + "127"),
        "ivf_batch_topk": (ivf_src[0], ivf_src[1] + "341"),
        "ivf_batch_topk_f32": (ivf_src[0], ivf_src[1] + "341"),
        "ivf_batch_topk_int8": (ivf_src[0], ivf_src[1] + "369"),
        "ivf_probe_topk_int4": (ivf_src[0], ivf_src[1] + "218"),
        "ivf_batch_topk_int4": (ivf_src[0], ivf_src[1] + "401"),
        "matvec_int4": ("matvec_int4.cu", "mediquery_rag_tpu/ops/matvec.py:228"),
        "flash_decode_int8": ("flash_decode.cu", "mediquery_rag_tpu/ops/attention.py:171"),
        "flash_decode_ml": ("flash_decode.cu", "mediquery_rag_tpu/ops/attention.py:171"),
        "flash_prefill_int8": ("flash_prefill.cu", "mediquery_rag_tpu/ops/attention.py:72"),
        "flash_dq": ("flash_backward.cu", "mediquery_rag_tpu/ops/attention.py:532"),
        "flash_dkv": ("flash_backward.cu", "mediquery_rag_tpu/ops/attention.py:602"),
    }
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{"name": name, "route": "cuda",
                "source": f"mediquery_rag_tpu_torch/csrc/{src}", "replaces": tpu,
                "launches": launches[name], **{key: table[name][key] for key in keys}}
               for name, (src, tpu) in sources.items()]
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
