"""Host-streaming flat index (port of ``mediquery_rag_tpu/engine/streaming.py``).

The capacity tier for corpora larger than device memory: the corpus stays
in host RAM (or an on-disk memmap after ``load``) as fixed ``[chunk_rows,
D]`` chunks, int8 with per-row scales or bf16/f32 rows, and every search
streams all of them through the card. Each chunk reaches the card through
two pinned staging buffers on a side stream (``engine/flat.py:
stream_to_device``), chunk ``i+1``'s copy overlapping chunk ``i``'s scan;
the scan is B2 (``int8_flat_search``) for int8, B1 over the chunk cast to
f32 on the card (``flat_search``, f32 B1) for bf16 and f32, and its top-k
folds into a running ``[B, k]`` on the card (``ops/topk.py:merge_topk``).
Only the final lists come back. The host link, not the card's memory, is
the speed of light here: amortize the streamed bytes over large batches.

Rows are L2-normalized at build (whatever the metric, as in JAX). The index
is immutable: it has no ``add``/``delete``, so a ``DocumentStore`` over it
refuses live changes. ``save`` writes raw ``corpus.bin``/``scales.bin`` and
``meta.json`` (bf16 as its 16-bit patterns), the JAX package's files, and
``load`` memmaps them; either package reads the other's.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np
import torch

from mediquery_rag_tpu_torch.config import EngineConfig
from mediquery_rag_tpu_torch.engine.flat import (
    _round_up, as_query_batch, bucket_queries, l2_normalize, stream_to_device)
from mediquery_rag_tpu_torch.ops.quant import int8_flat_search, quantize_rows
from mediquery_rag_tpu_torch.ops.scoring import flat_search
from mediquery_rag_tpu_torch.ops.topk import merge_topk

_DTYPES = {"int8": torch.int8, "bfloat16": torch.bfloat16, "float32": torch.float32}


def _prep_chunk_int8(block: torch.Tensor, chunk_rows: int):
    """Normalize and quantize one block on its device, padded to the fixed
    chunk shape: (int8 codes, f32 scales)."""
    q, s = quantize_rows(l2_normalize(block.float()))
    pad = chunk_rows - q.shape[0]
    return (torch.nn.functional.pad(q, (0, 0, 0, pad)),
            torch.nn.functional.pad(s, (0, pad)))


def _prep_chunk_int8_host(block: np.ndarray, chunk_rows: int):
    """Numpy mirror of ``_prep_chunk_int8`` (the same f32 steps and
    round-half-to-even), for builds that never touch the card."""
    v = block.astype(np.float32)
    v /= np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
    scale = np.maximum(np.max(np.abs(v), axis=-1), 1e-12) / 127.0
    q = np.clip(np.round(v / scale[:, None]), -127, 127).astype(np.int8)
    pad = chunk_rows - q.shape[0]
    if pad:
        q = np.pad(q, ((0, pad), (0, 0)))
        scale = np.pad(scale, ((0, pad),))
    return torch.from_numpy(q), torch.from_numpy(scale.astype(np.float32))


@dataclass
class StreamingFlatIndex:
    """``chunks``: ``[chunk_rows, D]`` host tensors (int8, bf16 or f32, the
    last zero-padded); ``scales``: ``[chunk_rows]`` f32 per chunk for int8,
    else None; ``n`` valid rows; searches run on ``device``."""

    chunks: list
    scales: list
    n: int
    cfg: EngineConfig
    chunk_rows: int
    device: str | torch.device = "cuda"

    SUPPORTED = ("int8", "bfloat16", "float32")

    @classmethod
    def build(cls, vectors, cfg: EngineConfig = EngineConfig(), chunk_rows: int = 1 << 20,
              prep: str = "device",
              device: str | torch.device = "cuda") -> "StreamingFlatIndex":
        """Chunk, normalize and quantize or cast ``vectors`` (a host array
        or memmap). ``prep="device"`` prepares each chunk on ``device`` and
        pulls it back (one chunk on the card at a time); ``prep="host"``
        (int8 only) quantizes in numpy and never touches the card."""
        return cls.build_from_blocks(
            (vectors[i:i + chunk_rows] for i in range(0, len(vectors), chunk_rows)),
            cfg, chunk_rows=chunk_rows, prep=prep, device=device)

    @classmethod
    def build_from_blocks(cls, blocks, cfg: EngineConfig = EngineConfig(),
                          chunk_rows: int = 1 << 20, prep: str = "device",
                          device: str | torch.device = "cuda") -> "StreamingFlatIndex":
        """Build from an iterator of row blocks of any sizes (a streaming
        embedding pipeline); they are repacked to exactly ``chunk_rows``
        rows, rounded up to the corpus tile."""
        if cfg.dtype not in cls.SUPPORTED:
            raise ValueError(f"streaming tier supports {cls.SUPPORTED}, got {cfg.dtype!r}")
        if prep not in ("device", "host"):
            raise ValueError(f"prep must be 'device' or 'host', got {prep!r}")
        if prep == "host" and cfg.dtype != "int8":
            raise ValueError("prep='host' supports int8 storage only")
        cfg = cfg.resolve_corpus_tile(chunk_rows)
        chunk_rows = _round_up(chunk_rows, cfg.corpus_tile)
        chunks, scales, n = [], [], 0
        buf: list[np.ndarray] = []
        buf_rows = 0

        def flush():
            nonlocal buf, buf_rows
            if not buf_rows:
                return
            block = np.concatenate(buf, axis=0) if len(buf) > 1 else buf[0]
            if prep == "host":
                c8, sc = _prep_chunk_int8_host(block, chunk_rows)
            elif cfg.dtype == "int8":
                c8, sc = (t.cpu() for t in _prep_chunk_int8(
                    torch.as_tensor(block).to(device), chunk_rows))
            else:
                v = l2_normalize(torch.as_tensor(block).to(device).float())
                c8 = torch.nn.functional.pad(v.to(_DTYPES[cfg.dtype]),
                                             (0, 0, 0, chunk_rows - v.shape[0])).cpu()
                sc = None
            chunks.append(c8)
            scales.append(sc)
            buf, buf_rows = [], 0

        for block in blocks:
            block = np.asarray(block)
            while block.shape[0]:
                take = min(chunk_rows - buf_rows, block.shape[0])
                buf.append(block[:take])
                buf_rows += take
                n += take
                block = block[take:]
                if buf_rows == chunk_rows:
                    flush()
        flush()
        if not chunks:
            raise ValueError("no rows")
        return cls(chunks=chunks, scales=scales, n=n, cfg=cfg, chunk_rows=chunk_rows,
                   device=device)

    def search(self, queries, k: int | None = None, *, prefetch: bool = True):
        """Exact global top-k, every chunk streamed through the card and
        folded into a running top-k there. Returns (scores ``[B, k]`` f32,
        row ids ``[B, k]`` i32) as host tensors; a 1-D query gives 1-D
        results. ``prefetch=False`` is the synchronous ablation (each copy
        lands, and each fold finishes, before the next copy starts)."""
        k = self.cfg.top_k if k is None else k
        queries, squeeze = as_query_batch(queries)
        q_pad, b = bucket_queries(queries)
        q = q_pad.to(self.device).float()
        if self.cfg.metric == "cosine":
            q = l2_normalize(q)
        int8 = self.cfg.dtype == "int8"
        run_s = torch.full((q.shape[0], k), float("-inf"), device=q.device)
        run_i = torch.zeros((q.shape[0], k), dtype=torch.int32, device=q.device)
        items = ((c, s) if int8 else (c,) for c, s in zip(self.chunks, self.scales))
        tiles = {"query_tile": self.cfg.query_tile, "corpus_tile": self.cfg.corpus_tile}
        for ci, dev_items in enumerate(stream_to_device(items, self.device,
                                                        prefetch=prefetch)):
            offset = ci * self.chunk_rows
            n_valid = min(self.chunk_rows, self.n - offset)
            if int8:
                s, i = int8_flat_search(q, *dev_items, k, n_valid=n_valid, **tiles)
            else:
                s, i = flat_search(q, dev_items[0].float(), k, n_valid=n_valid, **tiles)
            run_s, run_i = merge_topk(run_s, run_i, s, i + offset, k)
        run_s, run_i = run_s[:b].cpu(), run_i[:b].cpu()
        if squeeze:
            return run_s[0], run_i[0]
        return run_s, run_i

    # -- persistence: raw .bin files + meta.json, memmapped on load ---------------

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        d = self.chunks[0].shape[1]
        with open(os.path.join(path, "corpus.bin"), "wb") as f:
            for c in self.chunks:
                if c.dtype == torch.bfloat16:              # the 16-bit patterns
                    c = c.view(torch.int16)
                f.write(c.contiguous().numpy().tobytes())
        if self.scales[0] is not None:
            with open(os.path.join(path, "scales.bin"), "wb") as f:
                for s in self.scales:
                    f.write(s.contiguous().numpy().tobytes())
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"n": self.n, "d": d, "chunk_rows": self.chunk_rows,
                       "n_chunks": len(self.chunks), "cfg": self.cfg.__dict__,
                       "kind": "streaming_flat"}, f)

    @classmethod
    def load(cls, path: str, device: str | torch.device = "cuda") -> "StreamingFlatIndex":
        """Memmap an index saved by this class or by the JAX package: the
        chunks are views of the files (copy-on-write), paged in as they
        stream."""
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        cfg = EngineConfig(**{**EngineConfig().__dict__, **meta["cfg"]})
        rows, d, nc = meta["chunk_rows"], meta["d"], meta["n_chunks"]
        np_dt = {"int8": np.int8, "float32": np.float32, "bfloat16": np.int16}[cfg.dtype]
        raw = torch.from_numpy(np.memmap(os.path.join(path, "corpus.bin"), dtype=np_dt,
                                         mode="c", shape=(nc * rows, d)))
        if cfg.dtype == "bfloat16":
            raw = raw.view(torch.bfloat16)
        chunks = [raw[i * rows:(i + 1) * rows] for i in range(nc)]
        scales: list = [None] * nc
        if cfg.dtype == "int8":
            sraw = torch.from_numpy(np.memmap(os.path.join(path, "scales.bin"),
                                              dtype=np.float32, mode="c", shape=(nc * rows,)))
            scales = [sraw[i * rows:(i + 1) * rows] for i in range(nc)]
        return cls(chunks=chunks, scales=scales, n=meta["n"], cfg=cfg, chunk_rows=rows,
                   device=device)

    @property
    def nbytes_host(self) -> int:
        """Host bytes of the chunks and their scales."""
        n = sum(c.numel() * c.element_size() for c in self.chunks)
        return n + sum(s.numel() * 4 for s in self.scales if s is not None)
