"""Entry point: ``python -m mediquery_rag_tpu_torch.cli`` (port of
``mediquery_rag_tpu/cli/__main__.py``; ``--device`` replaces JAX's ``--cpu``)."""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m mediquery_rag_tpu_torch.cli",
                                 description="MediQuery CLI on PyTorch")
    ap.add_argument("--fake-llm", action="store_true",
                    help="run without a local LLM server (placeholder answers)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="torch device for the index and the on-device models "
                         "(no fallback to the CPU when no GPU is found)")
    ap.add_argument("--root", default=".", help="data root directory")
    ap.add_argument("--llm-url", default="http://localhost:11434")
    ap.add_argument("--index", choices=("flat", "ivf"), default=None,
                    help="index type (default: config/engine.index_kind)")
    args = ap.parse_args(argv)

    from mediquery_rag_tpu_torch.cli.context import AppContext
    from mediquery_rag_tpu_torch.cli.interface import main_menu

    if args.device == "cuda":
        print("初始化引擎（CUDA 内核首次使用时编译到 build/kernels/）…")
    else:
        print("初始化引擎（CPU）…")
    ctx = AppContext.build(
        args.root,
        fake_llm=args.fake_llm,
        llm_url=args.llm_url,
        index_kind=args.index,
        device=args.device,
    )
    print(f"就绪：{len(ctx.store.chunks)} 条知识库条目。")
    main_menu(ctx)


if __name__ == "__main__":
    main()
