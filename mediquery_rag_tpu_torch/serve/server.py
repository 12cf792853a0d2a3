"""``python -m mediquery_rag_tpu_torch.serve``: /search and /qa from the GPU.

The port of ``mediquery_rag_tpu/serve/server.py``'s ``main``. The HTTP
front itself (``SearchServer``), the micro-batcher and the Self-RAG graph
are the JAX package's jax-free modules, shared as they are; what runs
underneath is the port's document store and decoder. The continuous-
batching ``LLMServer`` (and with it ``/v1/chat/completions`` and
``--draft``) is not ported: /qa's graph gets the context's LLM client
directly, a lockstep ``Generator``, as the JAX entry does when it has no
``LLMServer``. Like the JAX entry, the context uses the scripted fake LLM
unless ``--llm-url`` is given.
"""

from __future__ import annotations

import argparse
import threading

from mediquery_rag_tpu.graph import build_medical_graph, create_nodes
from mediquery_rag_tpu.serve.server import SearchServer


def build_server(store, llm, *, web_search=None) -> SearchServer:
    """A ``SearchServer`` over ``store`` whose /qa runs the Self-RAG graph
    with ``llm``; the graph's retrieve node searches through the server's
    micro-batcher, as in the JAX entry."""
    server = SearchServer(store)

    def make_app():
        nodes = create_nodes(llm, server.service, web_search=web_search)
        return build_medical_graph(nodes)

    server._make_graph_app = make_app
    return server


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m mediquery_rag_tpu_torch.serve")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8384)
    ap.add_argument("--fake-llm", action="store_true")
    ap.add_argument("--llm-url", default=None)
    ap.add_argument("--draft", default=None,
                    help="speculative draft model (not ported; raises)")
    ap.add_argument("--index", choices=("flat", "ivf"), default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device for the index and the decoder")
    args = ap.parse_args(argv)
    if args.draft:
        raise NotImplementedError(
            "--draft needs the continuous-batching LLMServer and speculative "
            "decoding, ROADMAP Queue B items of the port")

    from mediquery_rag_tpu_torch.cli.context import AppContext

    ctx = AppContext.build(
        ".", fake_llm=args.fake_llm or not args.llm_url,
        llm_url=args.llm_url or "http://localhost:11434",
        index_kind=args.index, device=args.device)
    server = build_server(ctx.store, ctx.llm, web_search=ctx.web_search)
    if args.device.startswith("cuda"):
        from mediquery_rag_tpu_torch.ops import _build
        print("building kernels...", flush=True)
        _build.build_all()     # eager kernels: one build, no per-shape warm-up
    port = server.start(args.host, args.port)
    print(f"serving on http://{args.host}:{port}  "
          "(/search /qa /healthz /metrics /v1/embeddings)")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
