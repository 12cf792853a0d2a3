# SearchServer is a copy of mediquery_rag_tpu/serve/server.py:SearchServer (the port imports nothing of the JAX package).
"""HTTP serving front of the port, and ``python -m mediquery_rag_tpu_torch.serve``.

``SearchServer`` is the JAX package's stdlib HTTP front, copied: /search
through the micro-batcher, /qa through the Self-RAG graph, /v1/embeddings,
/healthz, /metrics, and the live index admin ``POST /documents`` (embed +
``FlatIndex.add``) and ``POST /documents/delete`` (``FlatIndex.delete``),
serialized by ``_mut_lock``. A mutation builds a new index and swaps the
store's reference, so a search running meanwhile sees the old index or the
new one, never a mix. Errors reply as JSON (4xx for caller faults, 5xx for
server faults). ``/v1/chat/completions`` (streamed or not) goes through
the continuous-batching ``serve.llm.LLMServer``; without one it replies 400.

``main`` ports the JAX entry (``build_app_server``): when the app context
serves its own decoder (a ``TorchLLMClient``), an ``LLMServer`` with 4 slot
lanes runs it, ``/v1/chat/completions`` is exposed, and /qa's Self-RAG
graph calls the same decode loop through ``ServedLLMClient``; otherwise
/qa's graph gets the context's client directly. As in the JAX entry, the
context uses the scripted fake LLM unless ``--llm-url`` is given; then an
HF checkpoint named by ``MEDIQUERY_HF_LLM`` or a decoder checkpoint under
``checkpoints/lm`` is served from the card ahead of the HTTP client.
``--draft`` takes either kind of checkpoint directory.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from mediquery_rag_tpu_torch.graph import build_medical_graph, create_nodes
from mediquery_rag_tpu_torch.ingest.parser import Chunk
from mediquery_rag_tpu_torch.obs import tracing
from mediquery_rag_tpu_torch.serve.batcher import BatchingSearchService
from mediquery_rag_tpu_torch.serve.llm import LLMServer, ServedLLMClient, ServerSaturated


def _doc_json(d) -> dict:
    return {"text": d.text, "metadata": d.metadata, "score": d.score}


def _stream_visible(acc: str, stops) -> tuple[int, bool]:
    """How much of the accumulated model text is safe to stream now.

    Returns ``(n_chars, cut_hit)``: cut at the first complete stop marker
    (cut_hit=True); otherwise hold back the longest tail that is still a
    PREFIX of some marker — it may complete on the next delta. Trailing
    whitespace is also held back, so the emitted total matches
    ``_cut_turn(acc).strip()`` once the stream ends."""
    cut, hit = len(acc), False
    for s in stops:
        i = acc.find(s)
        if 0 <= i < cut:
            cut, hit = i, True
    if not hit:
        hold = 0
        for s in stops:
            for k in range(min(len(s) - 1, cut), 0, -1):
                if acc.endswith(s[:k]):
                    hold = max(hold, k)
                    break
        cut -= hold
    while cut > 0 and acc[cut - 1].isspace():
        cut -= 1
    return cut, hit


class SearchServer:
    """Wires a DocumentStore (and optionally a graph factory) behind HTTP.

    ``make_graph_app``: optional zero-arg callable returning a compiled
    Self-RAG graph whose retrieve node uses THIS server's batcher (pass
    ``server.service`` as the store when building nodes) — /qa is disabled
    when absent.
    """

    def __init__(self, store, *, make_graph_app=None, max_batch: int = 64,
                 max_wait_ms: float = 3.0, llm_server=None,
                 chat_template: str = "plain"):
        self.store = store
        self.service = BatchingSearchService(
            store.batch_search, max_batch=max_batch, max_wait_ms=max_wait_ms)
        self._make_graph_app = make_graph_app
        self.llm_server = llm_server          # serve.llm.LLMServer | None
        self.chat_template = chat_template
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        # index mutations are functional snapshot swaps (safe vs concurrent
        # searches) but must not interleave with EACH OTHER
        self._mut_lock = threading.Lock()
        # /v1/embeddings coalescer (lazy: only servers that actually serve
        # embeddings pay for the collector thread)
        self._embed_batcher = None
        self._embed_lock = threading.Lock()

    # -- request handling ------------------------------------------------

    def _handle_search(self, body: dict) -> dict:
        queries = body.get("queries")
        if queries is None:
            queries = [body["query"]]
        k = int(body.get("k", 5))
        where = body.get("where")
        if where is not None:
            # where-filtering needs the store's widened fallback, not the
            # batcher (mixed filters cannot share one engine call)
            rows = self.store.batch_search(queries, k, where=where)
        else:
            futs = [self.service.submit(q, k) for q in queries]
            rows = [f.result(timeout=30) for f in futs]
        return {"results": [[_doc_json(d) for d in row] for row in rows]}

    def _handle_qa(self, body: dict) -> dict:
        if self._make_graph_app is None:
            raise ValueError("/qa is not configured (no graph factory)")
        from mediquery_rag_tpu_torch.llm.messages import user

        app = self._make_graph_app()
        events = list(app.stream(
            {"messages": [user(body["question"])],
             "user_id": body.get("user_id", "anonymous")},
            thread_id=body.get("thread_id", f"http_{uuid.uuid4().hex[:8]}")))
        final = events[-1][1]
        return {
            "answer": final.get("final_answer", ""),
            "docs": final.get("documents", []),
        }

    def _stream_qa(self, body: dict, write_sse) -> None:
        """SSE streaming for /qa: one ``{"event": "node", ...}`` progress
        event per Self-RAG super-step (the ``app.stream`` surface the
        reference consumed from LangGraph, ui/interface.py:293-307 printed
        the summarizer event of exactly this stream), then a final
        ``{"event": "answer", ...}`` and the [DONE] sentinel. A client
        watching the stream sees retrieve→grade→(rewrite|web) loop turns
        as they happen instead of one opaque multi-second wait."""
        from mediquery_rag_tpu_torch.llm.messages import user

        app = self._make_graph_app()
        thread_id = body.get("thread_id", f"http_{uuid.uuid4().hex[:8]}")
        state: dict = {}
        for node, state in app.stream(
                {"messages": [user(body["question"])],
                 "user_id": body.get("user_id", "anonymous")},
                thread_id=thread_id):
            write_sse({
                "event": "node",
                "node": node,
                "mode": state.get("mode"),
                "loop_step": state.get("loop_step", 0),
                "n_docs": len(state.get("documents") or []),
                "used_web_search": bool(state.get("used_web_search")),
            })
        write_sse({
            "event": "answer",
            "answer": state.get("final_answer", ""),
            "docs": state.get("documents", []),
            "thread_id": thread_id,
        })
        write_sse("[DONE]")

    def _handle_embeddings(self, body: dict) -> dict:
        """OpenAI-compatible /v1/embeddings over the TPU embedder — the
        other half of the daemon the reference consumed (its
        medical_engine.py:43 pulled OllamaEmbeddings over this API; chat
        is served by /v1/chat/completions). Batched: a list input is one
        TPU program."""
        emb = getattr(self.store, "embedder", None)
        if emb is None:
            raise ValueError("/v1/embeddings is not configured (no embedder)")
        inp = body["input"]
        texts = [inp] if isinstance(inp, str) else list(inp)
        if not texts or not all(isinstance(t, str) for t in texts):
            raise ValueError("input must be a string or list of strings")
        if self._embed_batcher is None:
            from mediquery_rag_tpu_torch.serve.batcher import MicroBatcher
            with self._embed_lock:
                if self._embed_batcher is None:
                    # resolve the embedder at call time: index admin can
                    # swap self.store, and the coalescer must follow it
                    self._embed_batcher = MicroBatcher(
                        lambda ts: list(self.store.embedder(ts)))
        import numpy as np
        vecs = np.asarray(self._embed_batcher.submit_many(texts))
        n_tok = sum(len(t) for t in texts)
        return {
            "object": "list",
            "model": body.get("model", "mediquery-tpu-embedder"),
            "data": [{"object": "embedding", "index": i,
                      "embedding": [float(x) for x in v]}
                     for i, v in enumerate(vecs)],
            "usage": {"prompt_tokens": n_tok, "total_tokens": n_tok},
        }

    def _handle_docs_add(self, body: dict) -> dict:
        """Index admin: embed + insert documents into the live index
        (DocumentStore.add_documents — Chroma add parity over HTTP).
        Searches running concurrently see the old or new index snapshot,
        never a torn one."""
        docs = body["documents"]
        chunks = []
        for d in docs:
            if not d.get("chunk_id"):
                raise ValueError("every document needs a chunk_id")
            chunks.append(Chunk(
                chunk_id=str(d["chunk_id"]), title=d.get("title", ""),
                content=d.get("content", d.get("text", "")),
                source=d.get("source", "http"),
                tags=list(d.get("tags", []))))
        with self._mut_lock:
            ids = self.store.add_documents(chunks)
        return {"added": len(ids), "doc_ids": [int(i) for i in ids]}

    def _handle_docs_delete(self, body: dict) -> dict:
        with self._mut_lock:
            n = self.store.delete_documents(
                [str(c) for c in body["chunk_ids"]])
        return {"deleted": n}

    def _chat_prompt(self, body: dict) -> tuple[str, dict]:
        """OpenAI request -> (rendered prompt, generation kwargs)."""
        from mediquery_rag_tpu_torch.llm.messages import Message
        from mediquery_rag_tpu_torch.llm.torch_client import render_chat

        if self.llm_server is None:
            raise ValueError(
                "/v1/chat/completions is not configured (no llm_server)")
        msgs = [Message.from_dict(m) for m in body["messages"]]
        prompt = render_chat(msgs, template=self.chat_template)
        kw = {
            "max_new_tokens": int(body.get("max_tokens", 256)),
            "temperature": float(body.get("temperature", 0.0)),
            "top_p": float(body.get("top_p", 1.0)),
            "schema": body.get("schema"),
        }
        return prompt, kw

    def _handle_chat(self, body: dict) -> dict:
        from mediquery_rag_tpu_torch.llm.torch_client import _cut_turn

        prompt, kw = self._chat_prompt(body)
        fut = self.llm_server.submit(prompt, **kw)
        try:
            out = fut.result(timeout=600.0)
        except Exception:
            fut.cancel()       # timed out / interrupted: free the lane
            raise
        if kw["schema"] is not None:
            content, cut = out.strip(), False
        else:
            content = _cut_turn(out, self.chat_template)
            cut = len(content) < len(out.strip())
        # a turn-marker cut is a natural stop even if the lane was
        # length-truncated further on
        finish = ("stop" if cut
                  else getattr(fut, "finish_reason", None) or "stop")
        return {
            "id": f"chatcmpl-{uuid.uuid4().hex[:12]}",
            "object": "chat.completion",
            "model": body.get("model", "mediquery-tpu"),
            "choices": [{
                "index": 0,
                "message": {"role": "assistant", "content": content},
                "finish_reason": finish,
            }],
        }

    def _stream_chat(self, body: dict, prompt: str, kw: dict,
                     write_sse, timeout: float = 600.0) -> None:
        """SSE streaming: one chunk per decode-chunk boundary (the server's
        scheduling quantum), then the OpenAI [DONE] sentinel.

        Deltas pass through an INCREMENTAL version of the non-streaming
        path's ``_cut_turn`` + strip: any tail that could still become a
        turn/stop marker (or trailing whitespace) is held back until more
        text disambiguates it, so concatenated stream deltas equal the
        non-streaming ``content`` for the same request."""
        import queue as _q
        import time as _time

        from mediquery_rag_tpu_torch.llm.torch_client import _turn_stops

        cid = f"chatcmpl-{uuid.uuid4().hex[:12]}"
        model = body.get("model", "mediquery-tpu")
        deltas: _q.Queue = _q.Queue()
        fut = self.llm_server.submit(prompt, on_text=deltas.put, **kw)
        stops = (() if kw["schema"] is not None
                 else _turn_stops(self.chat_template))
        acc, sent, cut_hit = "", 0, False
        deadline = _time.monotonic() + timeout

        def chunk(delta: str | None, finish: str | None) -> dict:
            d = {"content": delta} if delta else {}
            return {"id": cid, "object": "chat.completion.chunk",
                    "model": model,
                    "choices": [{"index": 0, "delta": d,
                                 "finish_reason": finish}]}

        def flush():
            nonlocal sent, cut_hit
            vis, cut_hit = _stream_visible(acc, stops)
            if sent == 0:                      # left-strip, like _cut_turn
                while sent < vis and acc[sent].isspace():
                    sent += 1
            if vis > sent:
                write_sse(chunk(acc[sent:vis], None))
                sent = vis

        try:
            while not cut_hit:
                try:
                    acc += deltas.get(timeout=0.05)
                    flush()
                except _q.Empty:
                    if fut.done():
                        break
                    if _time.monotonic() > deadline:   # dead worker: don't
                        raise TimeoutError(            # spin forever
                            f"stream produced nothing for {timeout:.0f}s")
            if not cut_hit:
                while not deltas.empty():          # drain the tail
                    acc += deltas.get()
                flush()
            if cut_hit:
                # the visible turn is over: stop the lane now instead of
                # decoding the rest of the budget into discarded text
                fut.cancel()
            finish = ("stop" if cut_hit
                      else getattr(fut, "finish_reason", None) or "stop")
            write_sse(chunk(None, finish))
            write_sse("[DONE]")
        except Exception:
            # client disconnected (broken pipe) or the stream died: cancel
            # so the lane stops decoding for nobody at the next chunk
            # boundary instead of burning the full token budget
            fut.cancel()
            raise

    def metrics_text(self) -> str:
        """Prometheus text exposition (0.0.4): search-service counters,
        LLM-server counters, request-latency gauges and the process's span
        totals (``obs.tracing``: count, host and device seconds and items
        per span name) — the scrape surface a production deployment puts
        behind its collector."""
        lines: list[str] = []

        def emit(name: str, value, mtype: str) -> None:
            lines.append(f"# TYPE {name} {mtype}")
            lines.append(f"{name} {value}")

        def batcher(prefix: str, stats: dict) -> None:
            for k, v in sorted(stats.items()):
                emit(f"{prefix}_{k}", v, "gauge" if k == "max_batch_seen" else "counter")

        batcher("mediquery_search", dict(self.service.stats))
        if self._embed_batcher is not None:
            batcher("mediquery_embed", dict(self._embed_batcher.stats))
        if self.llm_server is not None:
            for k, v in sorted(dict(self.llm_server.stats).items()):
                emit(f"mediquery_llm_{k}", v, "counter")
            for k, v in self.llm_server.latency().items():
                if v is not None:
                    emit(f"mediquery_llm_latency_{k}", v, "gauge")
        spans = sorted(tracing.totals().items())
        for field, name in (("count", "spans"), ("host_s", "span_seconds"),
                            ("device_s", "span_device_seconds"), ("n", "span_items")):
            lines.append(f"# TYPE mediquery_{name} counter")
            lines.extend(f'mediquery_{name}{{span="{k}"}} {t[field]}' for k, t in spans)
        emit("mediquery_spans_dropped", tracing.RECORDER.dropped, "counter")
        return "\n".join(lines) + "\n"

    # -- lifecycle ---------------------------------------------------------

    def start(self, host: str = "127.0.0.1", port: int = 8384) -> int:
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):           # quiet
                pass

            def _send(self, code: int, payload: dict):
                data = json.dumps(payload, ensure_ascii=False).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {"ok": True,
                                     "stats": dict(outer.service.stats)})
                elif self.path == "/metrics":
                    data = outer.metrics_text().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                else:
                    self._send(404, {"error": "not found"})

            def _sse(self, payload):
                if isinstance(payload, str):
                    data = payload
                else:
                    data = json.dumps(payload, ensure_ascii=False)
                self.wfile.write(f"data: {data}\n\n".encode())
                self.wfile.flush()

            def do_POST(self):
                sse_started = False
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    if self.path == "/search":
                        self._send(200, outer._handle_search(body))
                    elif self.path == "/qa":
                        if body.get("stream"):
                            # validate BEFORE committing SSE headers so a
                            # bad request still gets a clean HTTP 400
                            if outer._make_graph_app is None:
                                raise ValueError(
                                    "/qa is not configured (no graph factory)")
                            if not isinstance(body.get("question"), str) \
                                    or not body["question"]:
                                raise ValueError(
                                    "question must be a non-empty string")
                            self.send_response(200)
                            self.send_header("Content-Type",
                                             "text/event-stream")
                            self.send_header("Cache-Control", "no-cache")
                            self.end_headers()
                            sse_started = True
                            outer._stream_qa(body, self._sse)
                        else:
                            self._send(200, outer._handle_qa(body))
                    elif self.path == "/v1/embeddings":
                        self._send(200, outer._handle_embeddings(body))
                    elif self.path == "/documents":
                        self._send(200, outer._handle_docs_add(body))
                    elif self.path == "/documents/delete":
                        self._send(200, outer._handle_docs_delete(body))
                    elif self.path == "/v1/chat/completions":
                        if body.get("stream"):
                            # validate/render BEFORE committing SSE headers
                            # so a bad request still gets a clean HTTP 400
                            prompt, kw = outer._chat_prompt(body)
                            self.send_response(200)
                            self.send_header("Content-Type",
                                             "text/event-stream")
                            self.send_header("Cache-Control", "no-cache")
                            self.end_headers()
                            sse_started = True
                            outer._stream_chat(body, prompt, kw, self._sse)
                        else:
                            self._send(200, outer._handle_chat(body))
                    else:
                        self._send(404, {"error": "not found"})
                except Exception as e:          # fail-open JSON error
                    err = {"error": f"{type(e).__name__}: {e}"}
                    # honest status classes: caller bugs are 4xx, server
                    # trouble is 5xx (clients retry/alert on 5xx, not 400)
                    if isinstance(e, ServerSaturated):
                        code = 429
                    elif isinstance(e, TimeoutError):
                        code = 504      # incl. concurrent.futures timeout
                    elif isinstance(e, (KeyError, ValueError, TypeError,
                                        json.JSONDecodeError)):
                        code = 400
                    else:
                        code = 500
                    if sse_started:
                        # headers are committed — surface the error inside
                        # the stream and terminate it, never a 2nd status
                        try:
                            self._sse(err)
                            self._sse("[DONE]")
                        except Exception:
                            pass               # client already gone
                    else:
                        self._send(code, err)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self._httpd.server_address[1]

    def shutdown(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5)
            self._httpd.server_close()
        if self._embed_batcher is not None:
            self._embed_batcher.shutdown()
        self.service.shutdown()


def build_server(store, llm, *, web_search=None, llm_server: LLMServer | None = None,
                 template: str = "plain") -> SearchServer:
    """A ``SearchServer`` over ``store`` whose /qa runs the Self-RAG graph;
    the graph's retrieve node searches through the server's micro-batcher,
    as in the JAX entry. With ``llm_server`` the server also answers
    ``/v1/chat/completions`` and the graph's LLM calls ride the same
    continuous-batching loop (``ServedLLMClient``, with ``llm``'s token
    budget and temperature); else the graph calls ``llm`` directly."""
    server = SearchServer(store, llm_server=llm_server, chat_template=template)
    graph_llm = llm if llm_server is None else ServedLLMClient(
        llm_server, max_new_tokens=getattr(llm, "max_new_tokens", 256),
        temperature=getattr(llm, "temperature", 0.0), template=template)

    def make_app():
        nodes = create_nodes(graph_llm, server.service, web_search=web_search)
        return build_medical_graph(nodes)

    server._make_graph_app = make_app
    return server


def build_app_server(ctx, *, max_backlog: int = 64, draft=None,
                     gamma: int = 4) -> SearchServer:
    """The JAX entry's wiring over an app context (``store``, ``llm``,
    ``web_search``): a context LLM served from this process (a
    ``TorchLLMClient``) gets an ``LLMServer`` with 4 slot lanes behind
    ``/v1/chat/completions`` and /qa, speculative with ``draft`` (a
    ``Generator``) and ``gamma``; any other client serves /qa alone.
    The ``LLMServer`` (or None) is ``server.llm_server``; close it after
    ``server.shutdown()``."""
    from mediquery_rag_tpu_torch.llm.torch_client import TorchLLMClient

    llm_server, template = None, "plain"
    if isinstance(ctx.llm, TorchLLMClient):
        llm_server = LLMServer(ctx.llm.generator, slots=4, draft=draft, gamma=gamma,
                               max_backlog=max_backlog)
        template = ctx.llm.template
    return build_server(ctx.store, ctx.llm, web_search=ctx.web_search,
                        llm_server=llm_server, template=template)


def check_draft_dir(path: str) -> bool:
    """Whether ``path`` is an HF checkpoint (a ``config.json`` naming
    ``model_type``, the JAX entry's discriminator) rather than a
    ``Generator.save`` one. Raises ``FileNotFoundError`` for a directory
    without a config, or an HF one without ``*.safetensors``, so
    ``serve.main`` fails before it builds anything."""
    with open(os.path.join(path, "config.json"), encoding="utf-8") as f:
        hf = "model_type" in json.load(f)
    if hf and not glob.glob(os.path.join(path, "*.safetensors")):
        raise FileNotFoundError(f"no .safetensors files in {path}")
    return hf


def load_draft(path: str, *, quantize: int = 0, device: str = "cuda"):
    """The ``--draft`` model on ``device``: an HF qwen2-class checkpoint
    through ``load_qwen2_generator`` or a ``Generator.save`` checkpoint
    (e.g. from ``python -m mediquery_rag_tpu_torch.models.distill``),
    weight-quantized to ``quantize`` bits (0 = as loaded)."""
    from mediquery_rag_tpu_torch.models.generate import Generator
    from mediquery_rag_tpu_torch.models.hf_import import load_qwen2_generator

    if check_draft_dir(path):
        draft = load_qwen2_generator(path, device=device)
    else:
        draft = Generator.from_checkpoint(path, device=device)
    if quantize:
        draft.quantize_weights(bits=quantize)
    return draft


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m mediquery_rag_tpu_torch.serve")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8384)
    ap.add_argument("--fake-llm", action="store_true")
    ap.add_argument("--llm-url", default=None)
    ap.add_argument("--draft", default=None,
                    help="speculative draft model for the LLM server: an HF qwen2 "
                         "dir or a Generator checkpoint directory (e.g. a "
                         "models/distill.py draft)")
    ap.add_argument("--gamma", type=int, default=4,
                    help="draft tokens proposed per verify round (with --draft)")
    ap.add_argument("--draft-quantize", type=int, default=0, choices=(0, 4, 8),
                    help="int4/int8 weight-only quantization for the draft")
    ap.add_argument("--max-backlog", type=int, default=64,
                    help="queued LLM requests before 429 (0 = unbounded)")
    ap.add_argument("--index", choices=("flat", "ivf"), default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device for the index and the decoder")
    args = ap.parse_args(argv)
    if args.draft:
        check_draft_dir(args.draft)      # before the store is built

    from mediquery_rag_tpu_torch.cli.context import AppContext
    from mediquery_rag_tpu_torch.llm.torch_client import TorchLLMClient

    ctx = AppContext.build(
        ".", fake_llm=args.fake_llm or not args.llm_url,
        llm_url=args.llm_url or "http://localhost:11434",
        index_kind=args.index, device=args.device)
    if args.device.startswith("cuda"):
        from mediquery_rag_tpu_torch.ops import _build
        print("building kernels...", flush=True)
        _build.build_all()     # every csrc/*.cu library: one parallel build
    draft = None
    if args.draft and isinstance(ctx.llm, TorchLLMClient):
        draft = load_draft(args.draft, quantize=args.draft_quantize, device=args.device)
    server = build_app_server(ctx, max_backlog=args.max_backlog, draft=draft,
                              gamma=args.gamma)
    port = server.start(args.host, args.port)
    ix = ctx.store.index
    eps = "/search /qa /healthz /metrics /v1/embeddings /documents" + (
        " /v1/chat/completions" if server.llm_server is not None else "")
    print(f"serving on http://{args.host}:{port}  ({eps})  "
          f"index {type(ix).__name__} {ix.cfg.dtype} on {args.device}")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.shutdown()
        if server.llm_server is not None:
            server.llm_server.close()


if __name__ == "__main__":
    main()
