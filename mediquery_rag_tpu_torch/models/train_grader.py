"""Train the cross-encoder grader: ``python -m mediquery_rag_tpu_torch.models.train_grader``
(port of ``mediquery_rag_tpu/models/train_grader.py``).

Fine-tunes the joint (query, doc) relevance scorer on the corpus's
(title, content) pairs on ``--device`` (the card by default) and saves a
``TrainedGrader`` checkpoint, in the JAX package's format, that the CLI
loads from ``checkpoints/grader`` in place of the per-loop LLM document
grading.
"""

from __future__ import annotations

import argparse
from typing import Sequence


def grader_config(hidden: int = 128, layers: int = 2):
    """The JAX package's grader architecture (hash vocab 2048, 4 heads,
    MLP 2x hidden, 192 tokens, bf16 activations)."""
    from mediquery_rag_tpu_torch.config import EmbedderConfig
    return EmbedderConfig(vocab_size=2048, hidden=hidden, layers=layers, heads=4,
                          mlp_dim=2 * hidden, max_len=192, dtype="bfloat16")


def main(argv: Sequence[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", default="data/medical_data.txt")
    ap.add_argument("--out", default="checkpoints/grader")
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--batch-size", type=int, default=6)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from mediquery_rag_tpu_torch.ingest import parse_corpus_file
    from mediquery_rag_tpu_torch.models.cross_encoder import (
        TrainedGrader, train_cross_encoder)

    cfg = grader_config(args.hidden, args.layers)
    chunks = parse_corpus_file(args.corpus)
    pairs = [(c.title, c.content) for c in chunks]
    print(f"training grader on {len(pairs)} pairs...")
    params, _, loss = train_cross_encoder(
        pairs, cfg, epochs=args.epochs, batch_size=args.batch_size,
        lr=args.lr, device=args.device)
    print(f"final loss {loss:.4f}")
    TrainedGrader(params, cfg, device=args.device).save(args.out)
    print(f"saved grader -> {args.out}")


if __name__ == "__main__":
    main()
