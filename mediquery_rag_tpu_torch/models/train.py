"""Train the embedder on a corpus: ``python -m mediquery_rag_tpu_torch.models.train``
(port of ``mediquery_rag_tpu/models/train.py``).

End-to-end: parse corpus -> (title, content) pairs -> InfoNCE fine-tuning
on ``--device`` (the card by default) -> a ``TextEmbedder`` checkpoint
that either package loads (``MEDIQUERY_HYBRID=1`` serves it). The JAX
package's ``--dp``/``--tp`` mesh is ROADMAP Queue A item 13: values above 1
raise.
"""

from __future__ import annotations

import argparse
import time
from typing import Sequence


def main(argv: Sequence[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", default="data/medical_data.txt")
    ap.add_argument("--out", default="checkpoints/embedder")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--layers", type=int, default=None,
                    help="override encoder depth (small corpora train faster shallow)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from mediquery_rag_tpu_torch.config import EmbedderConfig, TrainConfig
    from mediquery_rag_tpu_torch.ingest import parse_corpus_file
    from mediquery_rag_tpu_torch.models.data import PairLoader, pairs_from_chunks
    from mediquery_rag_tpu_torch.models.embedder import MULTI_GPU
    from mediquery_rag_tpu_torch.models.text_embedder import TextEmbedder
    from mediquery_rag_tpu_torch.models.tokenizer import HashCharTokenizer
    from mediquery_rag_tpu_torch.models.trainer import ContrastiveTrainer

    if args.dp * args.tp > 1:
        raise NotImplementedError(MULTI_GPU)
    mcfg = EmbedderConfig() if args.layers is None else EmbedderConfig(layers=args.layers)
    tcfg = TrainConfig(batch_size=args.batch_size, lr=args.lr, warmup_steps=20)

    chunks = parse_corpus_file(args.corpus)
    pairs = pairs_from_chunks(chunks)
    print(f"corpus: {len(chunks)} chunks -> {len(pairs)} training pairs")

    tok = HashCharTokenizer(mcfg.vocab_size, mcfg.max_len)
    loader = PairLoader(pairs, tok, args.batch_size, seed=args.seed)
    trainer = ContrastiveTrainer(mcfg, tcfg, device=args.device)
    state = trainer.init_state(torch.Generator(device=args.device).manual_seed(args.seed))

    step = 0
    t0 = time.time()
    for batch in loader.batches(epochs=args.epochs):
        state, metrics = trainer.train_step(state, batch)
        step += 1
        if step % 10 == 0 or step == 1:
            print(f"step {step:5d}  loss {float(metrics['loss']):.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"{time.time() - t0:.1f}s")

    TextEmbedder(mcfg, params=state.params, device=args.device).save(args.out)
    print(f"saved params -> {args.out}")


if __name__ == "__main__":
    main()
