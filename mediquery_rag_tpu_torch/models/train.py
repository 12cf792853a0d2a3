"""Train the embedder on a corpus: ``python -m mediquery_rag_tpu_torch.models.train``
(port of ``mediquery_rag_tpu/models/train.py``).

End-to-end: parse corpus -> (title, content) pairs -> InfoNCE fine-tuning
on ``--device`` (the card by default) -> a ``TextEmbedder`` checkpoint
that either package loads (``MEDIQUERY_HYBRID=1`` serves it). ``--dp``/
``--tp`` above 1 spawn ``dp * tp`` ranks on ``--device`` (``cuda``: rank r
on ``cuda:r`` over NCCL; ``cpu``: gloo), each training its shard of the
JAX trainer's ``("data", "model")`` mesh; rank 0 saves the gathered
params.
"""

from __future__ import annotations

import argparse
import time
from typing import Sequence


def _train(mesh, args) -> None:
    """The corpus loop of ``main`` on one rank (``mesh`` None: one process)."""
    import torch

    from mediquery_rag_tpu_torch.config import EmbedderConfig, TrainConfig
    from mediquery_rag_tpu_torch.ingest import parse_corpus_file
    from mediquery_rag_tpu_torch.models.data import PairLoader, pairs_from_chunks
    from mediquery_rag_tpu_torch.models.text_embedder import TextEmbedder
    from mediquery_rag_tpu_torch.models.tokenizer import HashCharTokenizer
    from mediquery_rag_tpu_torch.models.trainer import ContrastiveTrainer

    mcfg = EmbedderConfig() if args.layers is None else EmbedderConfig(layers=args.layers)
    tcfg = TrainConfig(batch_size=args.batch_size, lr=args.lr, warmup_steps=20)
    lead = mesh is None or torch.distributed.get_rank() == 0

    chunks = parse_corpus_file(args.corpus)
    pairs = pairs_from_chunks(chunks)
    if lead:
        print(f"corpus: {len(chunks)} chunks -> {len(pairs)} training pairs", flush=True)

    tok = HashCharTokenizer(mcfg.vocab_size, mcfg.max_len)
    loader = PairLoader(pairs, tok, args.batch_size, seed=args.seed)
    trainer = ContrastiveTrainer(mcfg, tcfg, mesh=mesh, device=args.device)
    dev = trainer.device
    state = trainer.init_state(torch.Generator(device=dev).manual_seed(args.seed))

    step = 0
    t0 = time.time()
    for batch in loader.batches(epochs=args.epochs):
        state, metrics = trainer.train_step(state, batch)
        step += 1
        if lead and (step % 10 == 0 or step == 1):
            print(f"step {step:5d}  loss {float(metrics['loss']):.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"{time.time() - t0:.1f}s", flush=True)

    params = trainer.gather_params(state.params)
    if lead:
        TextEmbedder(mcfg, params=params, device=dev).save(args.out)
        print(f"saved params -> {args.out}", flush=True)


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
    from mediquery_rag_tpu_torch.parallel.dist import check_batch, launch
    check_batch(args.batch_size, args.dp)
    if args.dp * args.tp > 1:
        launch(_train, args.dp, args.tp, args, device=args.device)
    else:
        _train(None, args)


if __name__ == "__main__":
    main()
