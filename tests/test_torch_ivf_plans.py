"""The Hopper IVF scan's launch plan and work lists (B8a, B9a over bf16 and
f32 buckets, B8b and B8c over int8 and split-half packed int4 buckets:
``ops.ivf_kernel.ivf_scan_plan``, ``ivf_chunks_plain``, ``ivf_items``), the
live extent the scan reads (``ivf_extent``, kept by ``IVFIndex``) and the
arithmetic of its selection, on the CPU.

The kernel runs only on the card (``tests/test_torch_cuda.py``); here its
work items are held to covering every live slot of every probed (query,
bucket) pair exactly once and no slot at or past a bucket's extent, and a
plain-torch emulation of its filter on (score, doc id) against a stale
k-th, survivor slots that merge only when full, the merge by rank and pass
2 is held bit for bit to the plain versions. No JAX here: the plain
versions are held to the JAX kernels in ``tests/test_torch_ivf.py``.
"""

import os
import re

import numpy as np
import pytest
import torch

from mediquery_rag_tpu_torch.config import EngineConfig
from mediquery_rag_tpu_torch.engine import IVFIndex
from mediquery_rag_tpu_torch.ops import _build, ivf_kernel, quant
from mediquery_rag_tpu_torch.ops.scoring import SCAN_TILE

SLOTS = 32          # survivor slots per query (csrc/scan.cuh)


def _np_extent(ids: np.ndarray) -> np.ndarray:
    live = ids >= 0
    last = ids.shape[1] - np.argmax(live[:, ::-1], axis=1)
    return np.where(live.any(axis=1), last, 0).astype(np.int32)


def _packed_ids(rng, nlist: int, cap: int) -> np.ndarray:
    """Bucket ids as an index holds them: each bucket's docs packed at its
    front to its own count (an empty bucket, a full one, ragged ones: one
    whose extent ends just past a tile, so its last tile reaches into the
    next bucket's live rows), holes left by deletes inside the extents;
    distinct doc ids in no order."""
    counts = rng.integers(1, cap + 1, nlist)
    counts[0], counts[1 % nlist] = 0, cap
    counts[2 % nlist] = min(cap, SCAN_TILE + 1)
    ids = np.full((nlist, cap), -1, dtype=np.int32)
    docs = rng.permutation(10 * nlist * cap).astype(np.int32)
    for u, c in enumerate(counts):
        ids[u, :c] = docs[u * cap:u * cap + c]
    holes = rng.random((nlist, cap)) < 0.15
    ids[holes & (np.arange(cap)[None, :] < counts[:, None] - 1)] = -1
    return ids


def _probes(rng, b: int, nlist: int, nprobe: int) -> torch.Tensor:
    """Distinct probe ids per query, drawn from a few popular buckets so
    that many queries share them (runs longer than a chunk at large B)."""
    hot = rng.permutation(nlist)[:max(nprobe, nlist // 3)]
    return torch.from_numpy(np.stack([rng.permutation(hot)[:nprobe] for _ in range(b)])
                            .astype(np.int32))


def _launch_items(probe_ids, extent, plan, bucket_major):
    """(items, pos_bucket, pos_prober, n_chunks) of one launch, as the
    wrapper and the kernel cut it: positions sorted by bucket (stable),
    but at B = 1, where no bucket repeats, in probe order, each its own
    chunk in both layouts."""
    b, nprobe = probe_ids.shape
    flat = probe_ids.reshape(-1)
    pos_bucket, pos_prober = torch.sort(flat, stable=True) if b > 1 else (flat, None)
    chunk_e0, n_chunks = None, pos_bucket.shape[0]
    if bucket_major and b > 1:
        chunk_e0, n_chunks = ivf_kernel.ivf_chunks_plain(pos_bucket, plan.qb)
    items = ivf_kernel.ivf_items(plan, pos_bucket, pos_prober, chunk_e0, n_chunks, extent,
                                 nprobe)
    return items, pos_bucket, pos_prober, n_chunks


PLAN_CASES = [(b, cap, k, kind) for b in (1, 7, 64, 256) for cap, k, kind in
              ((96, 1, "bf16"), (2048, 10, "f32"), (256, 40, "bf16"), (2048, 128, "f32"),
               (2048, 40, "int8"), (96, 10, "int4"), (2048, 128, "int4"))]


def _item_slots(span, caph: int, ext: int) -> list:
    """The bucket slots an item's rows ``[r0, r1)`` score: the rows
    themselves, or for int4 (``caph``) the slots ``r`` and ``r + caph`` of
    each packed row below the extent."""
    r0, r1 = span
    if not caph:
        return list(range(r0, r1))
    return [s for r in range(r0, r1) for s in (r, r + caph) if s < ext]


@pytest.mark.parametrize("bucket_major", [False, True])
@pytest.mark.parametrize("b,cap,k,kind", PLAN_CASES)
def test_work_lists_cover_every_live_slot_once(b, cap, k, kind, bucket_major):
    """Every probed (query, bucket) pair's live slots [0, extent) are in
    exactly one item's piece, none at or past the extent (int4: the pieces
    are of min(extent, cap/2) packed rows, each scoring the slots of both its
    halves below the extent); every (prober, piece) list that pass 2 reads
    is written by exactly one item; a chunk's probers all probe its bucket
    and its query rows are theirs;
    the bucket-major chunks are the sorted probe list cut into runs of at
    most qb per bucket, one run per bucket while B <= qb (each bucket read
    once); the items fit the grid's walk and the lists pass 2's merge."""
    rng = np.random.default_rng(31)
    nlist, nprobe = 40, 8
    ids = _packed_ids(rng, nlist, cap)
    extent = torch.from_numpy(_np_extent(ids))
    pid = _probes(rng, b, nlist, nprobe)
    plan = ivf_kernel.ivf_scan_plan(kind, b, nprobe, 64, cap, k, bucket_major,
                                    min(b * nprobe, nlist))
    caph = cap // 2 if kind == "int4" else 0
    assert plan.smem <= _build.SMEM_PER_BLOCK and 2 <= plan.stages <= 8
    assert plan.qb == 16 or (bucket_major and plan.qb >= min(b, plan.qb))
    assert plan.caph == caph and (not caph or plan.qb <= 64)
    assert 1 <= plan.maxp <= -(-(caph or cap) // SCAN_TILE) and 1 <= plan.grid <= _build.SMS
    items, pos_bucket, pos_prober, n_chunks = _launch_items(pid, extent, plan, bucket_major)
    n_pos = b * nprobe
    assert n_chunks <= n_pos                          # the chunk_e0 scratch holds them
    n_items = n_chunks * plan.maxp
    walked = sorted(it for g in range(plan.grid) for it in range(g, n_items, plan.grid))
    assert walked == list(range(n_items))
    assert nprobe * plan.maxp <= ivf_kernel._MAX_LISTS

    flat = pid.reshape(-1).tolist()
    prober_of = list(range(n_pos)) if pos_prober is None else pos_prober.tolist()
    written: dict = {}
    covered: dict = {}
    slots: dict = {}
    gathered = bucket_major and b > 1       # queries in position order, chunks of runs
    for probers, u, p, (s0, s1), qrow in items:
        assert 1 <= len(probers) <= (plan.qb if gathered else 1)
        ext = int(extent[u])
        assert s1 <= (min(ext, caph) if caph else ext)
        for t, pr in enumerate(probers):
            assert flat[pr] == u
            # the query row of the chunk's t-th column is the prober's query
            if gathered:
                assert prober_of[qrow + t] == pr
            else:
                assert qrow == pr // nprobe
            written[(pr, p)] = written.get((pr, p), 0) + 1
            if s1 > s0:
                covered.setdefault(pr, []).append((s0, s1))
            slots.setdefault(pr, []).extend(_item_slots((s0, s1), caph, ext))
    assert written == {(pr, p): 1 for pr in range(n_pos) for p in range(plan.maxp)}
    for pr in range(n_pos):
        spans = sorted(covered.get(pr, []))
        ext = int(extent[flat[pr]])
        ends = [0] + [s1 for _, s1 in spans]
        assert [s0 for s0, _ in spans] == ends[:-1]
        assert ends[-1] == (min(ext, caph) if caph else ext)
        assert all(s0 % SCAN_TILE == 0 for s0, _ in spans)
        # every slot below the extent once (holes too: the ids mask them), none past it
        assert sorted(slots.get(pr, [])) == list(range(ext))

    if bucket_major:
        first = [it for it in items if it[2] == 0]
        got = [pr for it in first for pr in it[0]]
        assert got == prober_of and sorted(got) == list(range(n_pos))
        assert [it[1] for it in first for _ in it[0]] == pos_bucket.tolist()
        per_bucket = {}
        for _, u, _, _, _ in first:
            per_bucket[u] = per_bucket.get(u, 0) + 1
        runs = {u: flat.count(u) for u in set(flat)}
        assert per_bucket == {u: -(-n // plan.qb) for u, n in runs.items()}
        if b <= plan.qb:
            assert all(v == 1 for v in per_bucket.values())


def test_plans_at_the_serving_shape():
    """1M x 768 in 1,024 buckets of cap 2,048, nprobe 32, k = 10: at B = 1
    a half-full bucket's 8 tiles are 8 pieces (32 chunks fill the card); query-
    major chunks take 16 query columns (B = 64: two pieces a bucket, for
    about 16 items a block); bucket-major takes every prober of
    a bucket in one chunk up to B = 128, in 8 stages (5 at 128 probers a
    chunk: 32 KB a stage); f32 as bf16, its queries in the ring as well."""
    for kind in ("bf16", "f32"):
        one = ivf_kernel.ivf_scan_plan(kind, 1, 32, 768, 2048, 10, False)
        assert (one.qb, one.maxp, one.grid) == (16, 8, 132)
        qm = ivf_kernel.ivf_scan_plan(kind, 64, 32, 768, 2048, 10, False)
        assert (qm.qb, qm.maxp) == (16, 2)
        for b in (8, 64, 128):
            bm = ivf_kernel.ivf_scan_plan(kind, b, 32, 768, 2048, 10, True, min(32 * b, 1024))
            assert bm.qb >= b and bm.stages == (8 if b <= 64 else 5)
        assert ivf_kernel.ivf_scan_plan(kind, 256, 32, 768, 2048, 10, True, 1024).qb == 128
    # int8/int4: the fewest pieces, a power of two, that give every SM an
    # item: at B = 1 32 chunks x 8 (int4: its 1,024 packed rows a bucket make
    # 4 tiles of a half-full bucket, 128 items), one piece from B = 8 on; a
    # bucket-major chunk as many probers as a bucket's mean run (16 to B =
    # 512, 32 at 1,024), at most 64 (int4 32)
    one8 = ivf_kernel.ivf_scan_plan("int8", 1, 32, 768, 2048, 10, False)
    assert (one8.qb, one8.maxp, one8.grid, one8.stages, one8.caph) == (16, 8, 132, 8, 0)
    one4 = ivf_kernel.ivf_scan_plan("int4", 1, 32, 768, 2048, 10, False)
    assert (one4.qb, one4.maxp, one4.grid, one4.caph) == (16, 4, 128, 1024)
    for kind in ("int8", "int4"):
        for b in (8, 64, 256):
            assert ivf_kernel.ivf_scan_plan(kind, b, 32, 768, 2048, 40, False).maxp == 1
    for kind, big in (("int8", 64), ("int4", 32)):
        for b, qb in ((8, 16), (64, 16), (256, 16), (512, 16), (1024, 32), (4096, big)):
            assert ivf_kernel.ivf_scan_plan(kind, b, 32, 768, 2048, 10, True,
                                            min(32 * b, 1024)).qb == qb
    with pytest.raises(ValueError):
        ivf_kernel.ivf_scan_plan("bf16", 1, 32, 100, 2048, 10, False)     # 200-byte rows
    with pytest.raises(ValueError):
        ivf_kernel.ivf_scan_plan("f32", 1, 32, 768, 2048, 129, False)
    with pytest.raises(ValueError):
        ivf_kernel.ivf_scan_plan("int8", 1, 32, 72, 2048, 10, False)      # 72-byte rows


@pytest.mark.parametrize("qb", [1, 2, 16, 128])
def test_chunks_plain_follow_the_rule(qb):
    """A chunk starts at each bucket's first position and every qb
    positions after it, in position order; n_chunks of them are set."""
    rng = np.random.default_rng(32)
    sb = torch.from_numpy(np.sort(rng.integers(0, 9, 300)).astype(np.int32))
    e0, n = ivf_kernel.ivf_chunks_plain(sb, qb)
    want, start = [], 0
    for e in range(sb.shape[0]):
        if e == 0 or sb[e] != sb[e - 1]:
            start = e
        if (e - start) % qb == 0:
            want.append(e)
    assert n == len(want) and e0[:n].tolist() == want and e0.dtype == torch.int32


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_extent_follows_build_add_delete_and_load(dtype, tmp_path):
    """``IVFIndex.extent`` equals numpy's one-past-the-last-live-slot after
    build, ``build_streaming``, ``add`` (a bucket grows past its extent), a
    delete of a bucket's last live doc (the extent shrinks), a delete
    inside it (a hole: it stays) and a save/load round trip."""
    rng = np.random.default_rng(33)
    x = _unit(rng, 600, 32)
    cfg = EngineConfig(dim=32, dtype=dtype, ivf_nlist=16, ivf_kmeans_iters=3)
    ix = IVFIndex.build(x, cfg, device="cpu")

    def same(index):
        ids = index.bucket_ids.numpy()
        assert index.extent.dtype == torch.int32
        np.testing.assert_array_equal(index.extent.numpy(), _np_extent(ids))

    same(ix)
    same(IVFIndex.build_streaming(lambda: (x[i:i + 256] for i in range(0, 600, 256)), 600, cfg,
                                  chunk_rows=256, device="cpu"))
    grown = ix.add(_unit(rng, 40, 32))
    same(grown)
    ids = grown.bucket_ids.numpy()
    u = int(np.argmax((ids >= 0).sum(axis=1)))
    live = ids[u][ids[u] >= 0]
    tail = grown.delete([int(live[-1])])
    same(tail)
    assert int(tail.extent[u]) < int(grown.extent[u])
    hole = tail.delete([int(live[0])])
    same(hole)
    assert int(hole.extent[u]) == int(tail.extent[u])
    hole.save(str(tmp_path / "ix"))
    loaded = IVFIndex.load(str(tmp_path / "ix"), device="cpu")
    same(loaded)
    assert torch.equal(loaded.extent, hole.extent)


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_search_hands_its_extent_to_the_int_scans(dtype, monkeypatch):
    """``IVFIndex.search`` in the query-major layout hands the index's live
    extent to ``ivf_probe_search_int8``/``_int4``, whose kernels read only
    those slots (the plain versions mask by id alone)."""
    from mediquery_rag_tpu_torch.engine import ivf as engine_ivf

    rng = np.random.default_rng(36)
    cfg = EngineConfig(dim=32, dtype=dtype, ivf_nlist=16, ivf_kmeans_iters=3)
    ix = IVFIndex.build(_unit(rng, 600, 32), cfg, device="cpu")
    name = f"ivf_probe_search_{dtype}"
    inner, seen = getattr(engine_ivf, name), []

    def recording(*args, **kw):
        seen.append(kw.get("extent"))
        return inner(*args, **kw)

    monkeypatch.setattr(engine_ivf, name, recording)
    q = _unit(rng, 3, 32)
    s, i = ix.search(q, k=5, batched=False)
    assert len(seen) == 1 and seen[0] is ix.extent
    assert torch.equal(i, ix.search(q, k=5, batched=True)[1])


def _better(a, b):
    """(score, id) ``a`` before ``b``: score desc, then id asc."""
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


def _merge_by_rank(lst, cands, k):
    """scan.cuh's merge: a candidate's place is the count of list entries
    and other candidates before it; list entries move down by the count of
    candidates before them; places at k or past fall off."""
    out = [None] * k
    for j, e in enumerate(lst):
        pos = j + sum(_better(c, e) for c in cands)
        if pos < k:
            out[pos] = e
    for c in cands:
        pos = sum(_better(e, c) for e in lst) + sum(_better(o, c) for o in cands if o is not c)
        if pos < k:
            out[pos] = c
    return out


def _emulate(items, scores, ids, k, rng, caph=0, by_row=False):
    """The kernel's pass 1 in plain Python: per item, per 128-row tile of
    its piece, the entries (score, doc id) of its live query columns (int4,
    ``caph``: two slots a packed row), the filter against the k-th as of the
    last merge in a shuffled (fragment) order, slots of 32 per column merged
    only when full and at the item's end; lists per (prober, piece). scores
    [n_pos, nlist, cap] per prober, in slot order; ``by_row``: per row of the
    kernel's query map instead, column c of an item scoring with row qrow +
    c, as the kernel reads its queries (and int4 its corr)."""
    lists = {}
    for probers, u, p, (s0, s1), qrow in items:
        lst = {pr: [(-np.inf, np.iinfo(np.int32).max)] * k for pr in probers}
        slot = {pr: [] for pr in probers}
        srow = {pr: qrow + c if by_row else pr for c, pr in enumerate(probers)}
        for t0 in range(s0, s1, SCAN_TILE):
            tile = _item_slots((t0, min(t0 + SCAN_TILE, s1)), caph, ids.shape[1])
            ent = [(pr, float(scores[srow[pr], u, s]), int(ids[u, s]))
                   for s in tile for pr in probers if ids[u, s] >= 0]
            todo = [ent[i] for i in rng.permutation(len(ent))]
            while todo:
                left = []
                for pr, sc, i in todo:
                    if not _better((sc, i), lst[pr][-1]):
                        continue
                    (slot[pr] if len(slot[pr]) < SLOTS else left).append((pr, sc, i))
                if not left:
                    break
                for pr in probers:
                    lst[pr] = _merge_by_rank(lst[pr], [(s, i) for _, s, i in slot[pr]], k)
                    slot[pr] = []
                todo = left
        for pr in probers:
            lists[(pr, p)] = _merge_by_rank(lst[pr], [(s, i) for _, s, i in slot[pr]], k)
    return lists


def _pass2(lists, b, nprobe, maxp, k):
    out_s, out_i = [], []
    for q in range(b):
        ent = [e for j in range(nprobe) for p in range(maxp)
               for e in lists[(q * nprobe + j, p)] if e[0] != -np.inf]
        best = sorted(ent, key=lambda e: (-e[0], e[1]))[:k]
        best += [(-np.inf, 0)] * (k - len(best))
        out_s.append([e[0] for e in best])
        out_i.append([e[1] for e in best])
    return torch.tensor(out_s, dtype=torch.float32), torch.tensor(out_i, dtype=torch.int32)


def _int_case(dtype, rows, q, nlist, cap):
    """int8 or split-half packed int4 buckets of ``rows`` (f32, slot order),
    their slot scales ``[nlist, cap]``, the int8 queries and int4's corr,
    and each query's slot-ordered scores ``[B, nlist, cap]`` in the f32
    arithmetic of the plain versions."""
    q8, corr, _ = ivf_kernel.int4_query(q)
    if dtype == "int8":
        codes, scales = quant.quantize_rows(rows)
        per_q = (q8.double() @ codes.double().T).float() * scales
        return codes, scales.reshape(nlist, cap), q8, corr, per_q.reshape(-1, nlist, cap)
    codes, scales = quant.int4_codes(rows)
    packed = quant.ivf_pack_slots_int4(codes, nlist, cap)
    bk, s2 = ivf_kernel._int4_buckets(packed, torch.zeros(nlist, cap), scales)
    qd = q8.double()[:, None, :, None]                           # [B, 1, D, 1]
    du = (bk & 15).double()[None].matmul(qd)[..., 0].float()     # [B, nlist, cap/2]
    dp = bk.double()[None].matmul(qd)[..., 0].float()
    per_q = ivf_kernel._int4_slots(du, dp, corr[:, None, None], s2[None])
    return packed, scales.reshape(nlist, cap), q8, corr, per_q


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, "int8", "int4"])
@pytest.mark.parametrize("bucket_major", [False, True])
@pytest.mark.parametrize("b,k,dup,cap", [
    (1, 10, 1, 256),      # B = 1: a bucket in pieces, no sort
    (5, 40, 1, 256),      # k = 40: the first tiles overflow the slots
    (5, 10, 8, 256),      # duplicated rows: ties at the k-th, told apart by doc id
    (3, 128, 1, 32),      # fewer live slots than k: (-inf, 0)
])
def test_scan_emulation_equals_plain(dtype, bucket_major, b, k, dup, cap):
    """The work items, the filter on (score, doc id), the slots, the merge
    by rank and pass 2 give ivf_probe_search_plain's and
    ivf_batch_search_plain's scores and ids bit for bit (int8 and int4:
    the ``_int8``/``_int4`` plain versions), over bf16, f32, int8 and
    split-half packed int4 rows (packed rows carrying slots r and r +
    cap/2, both halves ragged), whatever order the survivors arrive in."""
    rng = np.random.default_rng(34)
    nlist, d, nprobe = 8, 32, 3
    ids = _packed_ids(rng, nlist, cap)
    rows = _unit(rng, nlist * cap // dup, d)
    rows = torch.from_numpy(np.concatenate([rows] * dup))
    q = torch.from_numpy(_unit(rng, b, d))
    pid = _probes(rng, b, nlist, nprobe)
    bids = torch.from_numpy(ids)
    extent = ivf_kernel.ivf_extent(bids)
    kind = {torch.float32: "f32", torch.bfloat16: "bf16"}.get(dtype, dtype)
    plan = ivf_kernel.ivf_scan_plan(kind, b, nprobe, d, cap, k, bucket_major,
                                    min(b * nprobe, nlist))
    items = _launch_items(pid, extent, plan, bucket_major)[0]
    uniq = ivf_kernel.unique_probes(pid, nlist)
    if kind in ("int8", "int4"):
        bk, scales, q8, corr, per_q = _int_case(kind, rows, q, nlist, cap)
        if kind == "int8" and bucket_major:
            plain = ivf_kernel.ivf_batch_search_plain(pid, uniq, q8, bk, bids, scales, k)
        elif kind == "int8":
            plain = ivf_kernel.ivf_probe_search_int8_plain(pid, q8, bk, bids, scales, k)
        elif bucket_major:
            plain = ivf_kernel.ivf_batch_search_int4_plain(pid, uniq, q8, corr, bk, bids,
                                                           scales, k)
        else:
            plain = ivf_kernel.ivf_probe_search_int4_plain(pid, q8, corr, bk, bids, scales, k)
    else:
        rows, q = rows.to(dtype), q.to(dtype)
        # each prober's query against every slot, as the plain versions round it
        per_q = (q.double() @ rows.double().T).float().reshape(b, nlist, cap)
        plain = (ivf_kernel.ivf_batch_search_plain(pid, uniq, q, rows, bids, None, k)
                 if bucket_major else ivf_kernel.ivf_probe_search_plain(pid, q, rows, bids, k))
    scores = per_q[torch.arange(b * nprobe) // nprobe].numpy()
    lists = _emulate(items, scores, ids, k, rng, plan.caph)
    es, ei = _pass2(lists, b, nprobe, plan.maxp, k)
    ps, pi = plain
    assert torch.equal(es, ps) and torch.equal(ei, pi)
    if k == 128:
        assert torch.isinf(es[:, -1]).all()


@pytest.mark.parametrize("b", [1, 7, 64, 256])
@pytest.mark.parametrize("bucket_major", [False, True])
def test_scan_inputs_gather_in_position_order(b, bucket_major):
    """``ivf_scan_inputs``, the host's half of every IVF scan: positions
    sorted by bucket as the work lists take them; bucket-major (B > 1)
    gathers the queries and int4's corr so that row e of both is query
    ``pos_prober[e] // nprobe``; query-major hands both over as given; at B =
    1 neither a sort nor a gather (the tensors themselves)."""
    rng = np.random.default_rng(38)
    nlist, nprobe, d = 16, 5, 32
    pid = _probes(rng, b, nlist, nprobe)
    q8, corr, _ = ivf_kernel.int4_query(torch.from_numpy(_unit(rng, b, d)))
    inp = ivf_kernel.ivf_scan_inputs(pid, q8, corr, bucket_major=bucket_major)
    if b == 1:
        assert inp.pos_prober is None and inp.queries is q8 and inp.corr is corr
        assert torch.equal(inp.pos_bucket, pid.reshape(-1))
        return
    _, pos_bucket, pos_prober, _ = _launch_items(
        pid, ivf_kernel.ivf_extent(torch.zeros((nlist, 32), dtype=torch.int32)),
        ivf_kernel.ivf_scan_plan("int4", b, nprobe, d, 64, 10, bucket_major), bucket_major)
    assert torch.equal(inp.pos_bucket, pos_bucket) and torch.equal(inp.pos_prober, pos_prober)
    assert inp.pos_bucket.dtype == torch.int32 and inp.pos_prober.dtype == torch.int64
    assert torch.equal(pid.reshape(-1)[inp.pos_prober], inp.pos_bucket)
    if not bucket_major:
        assert inp.queries is q8 and inp.corr is corr
        return
    rows = inp.pos_prober // nprobe
    assert inp.queries.shape == (b * nprobe, d) and inp.corr.shape == (b * nprobe,)
    for e in range(b * nprobe):
        assert torch.equal(inp.queries[e], q8[rows[e]]) and inp.corr[e] == corr[rows[e]]


@pytest.mark.parametrize("b", [7, 64, 256])
def test_int4_bucket_major_reads_corr_in_position_order(b):
    """The int4 bucket-major scan emulated as the kernel reads its inputs:
    column c of an item scores with query-map row qrow + c, its queries and
    corr those ``ivf_scan_inputs`` gathers; at B = 256 over three hot
    buckets every bucket has 256 probers, eight chunks of 32, so chunks past
    a bucket's first read corr far from its start. Bit-equal to
    ``ivf_batch_search_int4_plain``; the same emulation fed corr in query
    order (row e reading query e's corr, zeros past B) is not."""
    rng = np.random.default_rng(39)
    nlist, cap, d, nprobe, k = 8, 64, 32, 3, 10
    ids = _packed_ids(rng, nlist, cap)
    bids = torch.from_numpy(ids)
    rows = torch.from_numpy(_unit(rng, nlist * cap, d))
    q = torch.from_numpy(_unit(rng, b, d))
    pid = _probes(rng, b, nlist, nprobe)
    plan = ivf_kernel.ivf_scan_plan("int4", b, nprobe, d, cap, k, True, min(b * nprobe, nlist))
    items = _launch_items(pid, ivf_kernel.ivf_extent(bids), plan, True)[0]
    packed, scales, q8, corr, _ = _int_case("int4", rows, q, nlist, cap)
    bk, s2 = ivf_kernel._int4_buckets(packed, bids, scales)
    if b == 256:
        assert max(len(it[0]) for it in items) == plan.qb == 32
        assert len({it[1] for it in items}) < len(items)     # a bucket in several chunks
    inp = ivf_kernel.ivf_scan_inputs(pid, q8, corr, bucket_major=True)

    def row_scores(q_rows, corr_rows):
        """Each query-map row's slot scores ``[rows, nlist, cap]``."""
        qd = q_rows.double()[:, None, :, None]
        du = (bk & 15).double()[None].matmul(qd)[..., 0].float()
        dp = bk.double()[None].matmul(qd)[..., 0].float()
        return ivf_kernel._int4_slots(du, dp, corr_rows[:, None, None], s2[None]).numpy()

    def scan(corr_rows):
        lists = _emulate(items, row_scores(inp.queries, corr_rows), ids, k, rng, plan.caph,
                         by_row=True)
        return _pass2(lists, b, nprobe, plan.maxp, k)

    ps, pi = ivf_kernel.ivf_batch_search_int4_plain(
        pid, ivf_kernel.unique_probes(pid, nlist), q8, corr, packed, bids, scales, k)
    es, ei = scan(inp.corr)
    assert torch.equal(es, ps) and torch.equal(ei, pi)
    in_query_order = torch.cat([corr, torch.zeros(b * nprobe - b)])
    ws, _ = scan(in_query_order)
    assert not torch.equal(ws, ps)


def _c_qbmax() -> dict:
    """The most probers a chunk each IVF entry of ``csrc/ivf_topk.cu`` takes:
    the QBMAX of its ``ivf_scan<Stage, QBMAX>`` (the template's default
    where it names none)."""
    with open(os.path.join(_build.CSRC, "ivf_topk.cu")) as f:
        src = f.read()
    default = int(re.search(r"template <template <int> class S, int QBMAX = (\d+)>", src)[1])
    out = {}
    for m in re.finditer(r'extern "C" int (\w+)\(.*?\n\}', src, re.S):
        call = re.search(r"ivf_scan<[\w:]+(?:, (\d+))?>", m[0])
        if call:
            out[m[1]] = int(call[1] or default)
    return out


def test_plans_stay_within_the_c_entries():
    """``ivf_scan_plan`` never gives a chunk more probers than the C entry
    it launches dispatches (``_QB_MAX`` and the entries' QBMAX say the
    same): bucket-major up to 128 (int8 64, int4 32), query-major 16, over
    batches across every chunk size, two widths and k from 1 to 128."""
    qbmax = _c_qbmax()
    assert set(qbmax) == {f"ivf_{lay}_topk{sfx}" for lay in ("probe", "batch")
                          for sfx in ("", "_f32", "_int8", "_int4")}
    for kind, sfx in (("bf16", ""), ("f32", "_f32"), ("int8", "_int8"), ("int4", "_int4")):
        assert ivf_kernel._QB_MAX[kind] == qbmax[f"ivf_batch_topk{sfx}"]
        for b in (1, 7, 16, 17, 33, 64, 65, 100, 128, 129, 256, 1000, 4096):
            for d, k in ((64, 1), (768, 10), (768, 128)):
                bm = ivf_kernel.ivf_scan_plan(kind, b, 32, d, 2048, k, True, min(32 * b, 1024))
                qm = ivf_kernel.ivf_scan_plan(kind, b, 32, d, 2048, k, False)
                assert bm.qb <= qbmax[f"ivf_batch_topk{sfx}"]
                assert qm.qb == 16 <= qbmax[f"ivf_probe_topk{sfx}"]
    for kind in ("int8", "int4"):
        assert ivf_kernel.ivf_scan_plan(kind, 8192, 32, 768, 2048, 10, True, 1024).qb == (
            qbmax[f"ivf_batch_topk_{kind}"])


KINDS = ("bf16", "f32", "int8", "int4")


def test_layout_rule_thresholds_and_the_cpu_rule():
    """The card's layout rule at the shape of its measurement (``chip_smoke.py``
    phase 3c: nlist 1,024, nprobe 32) gives the thresholds PERF.md records,
    scales with the probes per bucket, and on the CPU is the JAX package's
    rule, ``B * nprobe >= 2 * nlist`` (``mediquery_rag_tpu/engine/ivf.py:558``),
    for every kind over a sweep of (B, nprobe, nlist)."""
    thr = {kind: ivf_kernel.ivf_layout_threshold(kind, 32, 1024) for kind in KINDS}
    assert thr == {"bf16": 16, "f32": 16, "int8": 32, "int4": 32}
    for kind in KINDS:
        assert ivf_kernel.ivf_layout_threshold(kind, 64, 1024) == max(2, -(-thr[kind] // 2))
        assert ivf_kernel.ivf_layout_threshold(kind, 32, 4096) == 4 * thr[kind]
        for b in (1, 2, 3, 7, 8, 15, 16, 17, 31, 32, 64, 100, 256, 1024):
            for nprobe, nlist in ((1, 1), (4, 8), (8, 64), (32, 1024), (32, 256), (16, 4096)):
                assert ivf_kernel.ivf_bucket_major(kind, b, nprobe, nlist, False) == (
                    b * nprobe >= 2 * nlist)
                assert ivf_kernel.ivf_bucket_major(kind, b, nprobe, nlist, True) == (
                    b >= ivf_kernel.ivf_layout_threshold(kind, nprobe, nlist))
        assert not ivf_kernel.ivf_bucket_major(kind, 1, 32, 1, True)


@pytest.mark.parametrize("dtype", ["float32", "int4"])
def test_search_on_the_cpu_picks_jax_layout(dtype, monkeypatch):
    """``IVFIndex.search(batched=None)`` on the CPU takes the bucket-major
    layout exactly when JAX's rule does (``B * nprobe >= 2 * nlist``), and
    gives what that layout gives when asked for it."""
    from mediquery_rag_tpu_torch.engine import ivf as engine_ivf

    rng = np.random.default_rng(40)
    cfg = EngineConfig(dim=32, dtype=dtype, ivf_nlist=16, ivf_kmeans_iters=3)
    ix = IVFIndex.build(_unit(rng, 600, 32), cfg, device="cpu")
    inner, seen = engine_ivf.ivf_batch_search, []

    def recording(*args, **kw):
        seen.append(args[0].shape[0])
        return inner(*args, **kw)

    monkeypatch.setattr(engine_ivf, "ivf_batch_search", recording)
    for b in (7, 8):                      # 7 * 4 < 2 * 16 <= 8 * 4
        q = _unit(rng, b, 32)
        s, i = ix.search(q, k=5, nprobe=4)
        assert seen == ([8] if b == 8 else [])
        es, ei = ix.search(q, k=5, nprobe=4, batched=b == 8)
        assert torch.equal(s, es) and torch.equal(i, ei)
