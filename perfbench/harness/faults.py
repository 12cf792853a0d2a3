"""Faults planted underneath the timed path, for the tests and the
readings that set each limit: each takes ``patch(owner, name, value)``
(``setattr``, or pytest's ``monkeypatch.setattr``) and breaks one thing
where the program produces it."""

from __future__ import annotations

import torch


def alter_token(patch):
    """Now and then every lane emits its worst token."""
    from mediquery_rag_tpu_torch.serve.llm import LLMServer
    orig, calls = LLMServer._pick, [0]

    def pick(self, logits, temps, top_ps):
        tok = orig(self, logits, temps, top_ps)
        calls[0] += 1
        if calls[0] % 5 == 3:
            tok = torch.argmin(logits, dim=-1)
        return tok

    patch(LLMServer, "_pick", pick)


def stale_state(patch):
    """After its first call the decode step returns the logits it returned
    then and leaves the cache as it was: the server's state never moves."""
    from mediquery_rag_tpu_torch.models.decoder import Decoder
    orig, last = Decoder.decode_step_slots, []

    def step(self, cache, token, active):
        if not last:
            last.append(orig(self, cache, token, active))
        return last[0].clone()

    patch(Decoder, "decode_step_slots", step)


def alter_answer(patch):
    """The best answer of every query swapped for another row."""
    from mediquery_rag_tpu_torch.engine.ivf import IVFIndex
    orig = IVFIndex.search

    def search(self, queries, k=None, nprobe=None, **kw):
        s, i = orig(self, queries, k, nprobe, **kw)
        i = i.clone()
        i[..., 0] = (i[..., 0] + self.n // 2) % self.n
        return s, i

    patch(IVFIndex, "search", search)


def stale_batch(patch):
    """Each batch gets the previous batch's answers."""
    from mediquery_rag_tpu_torch.engine.ivf import IVFIndex
    orig, last = IVFIndex.search, {}

    def search(self, queries, k=None, nprobe=None, **kw):
        s, i = orig(self, queries, k, nprobe, **kw)
        b = i.shape[0]
        prev = last.get(b)
        last[b] = (s, i)
        return prev if prev is not None else (s, i)

    patch(IVFIndex, "search", search)


def kmeans_cut(patch):
    """The index's k-means stops before its first iteration: the centroids
    are its initial rows."""
    from mediquery_rag_tpu_torch.engine import ivf
    orig = ivf.kmeans

    def kmeans(sample, gen, *, nlist, iters, **kw):
        return orig(sample, gen, nlist=nlist, iters=0, **kw)

    patch(ivf, "kmeans", kmeans)


def nprobe_half(patch):
    """Each query probes half the lists the configuration states."""
    from mediquery_rag_tpu_torch.engine.ivf import IVFIndex
    orig = IVFIndex.search

    def search(self, queries, k=None, nprobe=None, **kw):
        return orig(self, queries, k, max(1, self.cfg.ivf_nprobe // 2), **kw)

    patch(IVFIndex, "search", search)


FAULTS = {f.__name__: f for f in (alter_token, stale_state, alter_answer, stale_batch,
                                   kmeans_cut, nprobe_half)}
