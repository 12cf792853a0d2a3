"""The launch plans of the int4 decode matvec B7 (``ops.matvec.matvec4_plan``)
and the Hopper flat scans (``ops.scoring.scan_plan``: B1 bf16 and f32
``flat_scan_plan``, B2 ``ops.quant.int8_scan_plan``, B3
``ops.quant.int4_scan_plan``), and the arithmetic their kernels lean on, on
the CPU.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``);
here the plans are held to covering every output, weight and corpus row
exactly once within shared memory, and plain-torch emulations of the
kernels' cuts are held bit for bit to the plain versions: B7's int32
partial dots summed over its warps' quarters of D in two orders, and the
scans' filter against a stale k-th, survivor slots that merge only when
full, and a merge by rank, then pass 2 over the blocks' lists (int8 rows,
int4's two logical rows per byte-row, bf16 and f32 scores).
"""

import numpy as np
import pytest
import torch

from mediquery_rag_tpu_torch.ops import _build, matvec, quant, scoring

# (F/2, D): the 7B projections (qkv, attn_out, w_gate/w_up, w_down, lm_head)
# and ragged ones (D past a 1 KB slice, F/2 past a 16-row tile, D < 256)
MV4_SHAPES = [(2304, 3584), (1792, 3584), (9472, 3584), (1792, 18944), (192, 3584),
              (500, 400), (8, 48), (1000, 2064)]
MV4_ROWS = [1, 2, 4, 8, 9, 16, 20, 31, 32, 33, 64, 100, 128]


@pytest.mark.parametrize("f2,d", MV4_SHAPES)
def test_matvec4_plan_covers_every_row_once(f2, d):
    """Every (output row, x row) pair is in exactly one block; each block's
    warps walk all of D in 1 KB slices cut at 256-byte quarters (16-byte
    copies), and the ring and the partial dots fit a block's shared memory."""
    for rows in MV4_ROWS:
        plan = matvec.matvec4_plan(rows, f2, d)
        cover = np.zeros((rows, f2), dtype=np.int32)
        for m in range(plan.row_tiles):
            for g in range(plan.groups):
                r = slice(m * matvec.MV4_TILE_ROWS, (m + 1) * matvec.MV4_TILE_ROWS)
                b = slice(g * matvec.MV4_GROUP, (g + 1) * matvec.MV4_GROUP)
                cover[b, r] += 1
                assert 8 * plan.ntiles >= len(range(rows)[b])     # a block's x rows fit
        assert (cover == 1).all()
        assert plan.blocks == plan.row_tiles * plan.groups
        assert (plan.slices - 1) * matvec.MV4_SLICE < d <= plan.slices * matvec.MV4_SLICE
        quarters = np.arange(0, plan.slices * matvec.MV4_SLICE, matvec.MV4_SLICE // 4)
        assert (quarters % 16 == 0).all() and quarters[-1] < plan.slices * matvec.MV4_SLICE
        assert 2 <= plan.stages <= max(2, min(8, plan.slices))
        assert plan.smem_bytes() <= _build.SMEM_PER_BLOCK
        assert 1 <= plan.resident() <= plan.blocks and plan.waves() >= 1


def test_matvec4_plan_picks_fewest_waves():
    """Where a deeper ring would cost a block per SM, the plan keeps the
    shallower one (w_gate at 4 rows: 592 blocks, 2 stages, 4 blocks an SM);
    where every block fits at once it deepens the ring (w_down: 112
    blocks of 19 slices)."""
    gate = matvec.matvec4_plan(4, 9472, 3584)
    assert (gate.stages, gate.blocks, gate.waves()) == (2, 592, 2)
    down = matvec.matvec4_plan(4, 1792, 18944)
    assert down.waves() == 1 and down.stages > 2
    assert down.in_flight() >= matvec.MV4_IN_FLIGHT


def _int4_inputs(rng, b, f2, d):
    x8 = torch.from_numpy(rng.integers(-127, 128, (b, d)).astype(np.int8))
    q4 = torch.from_numpy(rng.integers(-128, 128, (f2, d)).astype(np.int8))
    s = torch.from_numpy(rng.random((2, f2)).astype(np.float32) * 1e-3)
    corr = 8.0 * x8.to(torch.int32).sum(dim=-1, keepdim=True).float()
    return x8, corr, q4, s


@pytest.mark.parametrize("b,f2,d", [(4, 48, 3584), (20, 40, 2064), (1, 16, 400), (33, 24, 1024)])
def test_matvec4_split_sums_equal_plain(b, f2, d):
    """B7's exactness: int32 partial dots over each warp's 256-byte
    quarters of each 1 KB slice, summed in two different orders, give the
    same integers, and the f32 epilogue on them equals int4_matmul_plain
    bit for bit."""
    rng = np.random.default_rng(20)
    x8, corr, q4, s = _int4_inputs(rng, b, f2, d)
    p = q4.to(torch.int64)
    xl = x8.to(torch.int64)
    step = matvec.MV4_SLICE // 4
    parts = [(xl[:, k:k + step] @ p[:, k:k + step].T, xl[:, k:k + step] @ (p[:, k:k + step] & 15).T)
             for k in range(0, d, step)]
    for order in (parts, parts[::-1], [parts[i] for i in rng.permutation(len(parts))]):
        dot_p = torch.zeros((b, f2), dtype=torch.int32)
        dot_u = torch.zeros((b, f2), dtype=torch.int32)
        for pp, uu in order:
            dot_p += pp.to(torch.int32)
            dot_u += uu.to(torch.int32)
        lo = (dot_u.float() - corr) * s[0][None, :]
        hi = (dot_p - dot_u).float() * 0.0625 * s[1][None, :]
        assert torch.equal(torch.cat([lo, hi], dim=-1), matvec.int4_matmul_plain(x8, corr, q4, s))


B2_CASES = [(b_pad, d, n_pad, k) for b_pad in (16, 32, 48, 64, 80, 128, 144, 256)
            for d, n_pad in ((64, 4096), (96, 4096), (768, 1 << 20), (3072, 131072))
            for k in (1, 10, 40, 128)]


def _hold_scan_plan(plan, b_pad, n_pad, k, qbs):
    """Every query is in exactly one group and every corpus tile in exactly
    one range of each group (ranges non-empty, in order); the query tile,
    ring, lists and slots fit a block's shared memory; one block per SM in
    all; the pass-1 lists hold b_pad x ranges x k entries."""
    assert plan.qb in qbs and plan.groups * plan.qb >= b_pad
    assert (plan.groups - 1) * plan.qb < b_pad
    assert plan.tiles * scoring.SCAN_TILE >= n_pad > (plan.tiles - 1) * scoring.SCAN_TILE
    spans = plan.tile_ranges()
    assert spans[0][0] == 0 and spans[-1][1] == plan.tiles
    assert all(a < b for a, b in spans)
    assert all(spans[i][1] == spans[i + 1][0] for i in range(len(spans) - 1))
    assert plan.ranges * plan.groups <= max(_build.SMS, plan.groups)
    assert 2 <= plan.stages <= 8 and plan.smem <= _build.SMEM_PER_BLOCK
    bufs = scoring.scan_lists(b_pad, plan.ranges, k, "cpu")
    assert [tuple(t.shape) for t in bufs] == [(b_pad, plan.ranges, k)] * 2 + [(b_pad, k)] * 2


@pytest.mark.parametrize("d", [64, 96, 768, 3072])
def test_int8_scan_plan_covers_every_row_once(d):
    """B2's plans (:func:`_hold_scan_plan`)."""
    for b_pad, dd, n_pad, k in B2_CASES:
        if dd != d:
            continue
        plan = quant.int8_scan_plan(b_pad, d, n_pad, k)
        _hold_scan_plan(plan, b_pad, n_pad, k, (16, 32, 64, 128))


# kind -> (plan of (b_pad, d, n_pad, k), queries a block may take)
SCAN_PLANS = {
    "bf16": (lambda *a: scoring.flat_scan_plan(*a, dtype=torch.bfloat16), (16, 32, 64, 128)),
    "f32": (lambda *a: scoring.flat_scan_plan(*a, dtype=torch.float32), (16, 32, 64, 128)),
    "int4": (quant.int4_scan_plan, (16, 32, 64)),
}


@pytest.mark.parametrize("d", [64, 96, 768, 3072])
@pytest.mark.parametrize("kind", list(SCAN_PLANS))
def test_flat_and_int4_scan_plans_cover_every_row_once(kind, d):
    """B1 bf16, B1 f32 and B3 (over packed byte-rows): the plans hold as
    B2's do; the query tile stays resident wherever it fits beside a
    4-stage ring (2 at 16 queries), and the queries ride in the ring
    otherwise; fewer queries a block only where neither fits."""
    fn, qbs = SCAN_PLANS[kind]
    esz = {"bf16": 2, "f32": 4, "int4": 1}[kind]
    limit = _build.SMEM_PER_BLOCK
    for b_pad, dd, n_pad, k in B2_CASES:
        if dd != d:
            continue
        n = n_pad // 2 if kind == "int4" else n_pad
        plan = fn(b_pad, d, n, k)
        _hold_scan_plan(plan, b_pad, n, k, qbs)
        floor_stages = 4 if plan.qb > 16 else 2
        resident = scoring._scan_smem(plan.qb, d * esz, k, floor_stages) <= limit
        assert plan.qstream == (not resident and
                                scoring._scan_smem(plan.qb, d * esz, k, 4) > limit)
        if plan.qb < min(b_pad, qbs[-1]):     # halved: neither layout fit the larger block
            assert all(scoring._scan_smem(2 * plan.qb, d * esz, k, 4, qs) > limit
                       for qs in (False, True))


def test_scan_plans_at_the_serving_shape():
    """At 1M x 768, k = 10: one pass over the corpus serves up to 128
    queries (int4: 64, two int32 sums a score); the query tile stays
    resident for int8 up to 128 queries, bf16 to 64, f32 to 32, and the
    queries ride in the ring beyond (f32 at B = 64); B = 1 and B = 64 take
    one group of 132 ranges; f32 at D = 3072 streams even 16 queries."""
    n = 1 << 20
    assert scoring.flat_scan_plan(64, 768, n, 10)[:3] == (64, 6, 1)
    assert not scoring.flat_scan_plan(64, 768, n, 10).qstream
    bf = scoring.flat_scan_plan(128, 768, n, 10)
    assert (bf.qb, bf.groups, bf.qstream) == (128, 1, True)
    f32 = scoring.flat_scan_plan(64, 768, n, 10, torch.float32)
    assert (f32.qb, f32.groups, f32.ranges, f32.qstream) == (64, 1, 132, True)
    assert not scoring.flat_scan_plan(32, 768, n, 10, torch.float32).qstream
    i8 = quant.int8_scan_plan(128, 768, n, 10)
    assert (i8.qb, i8.qstream) == (128, False)
    assert quant.int4_scan_plan(128, 768, n // 2, 10)[:4] == (64, 8, 2, 66)
    for kind in ("bf16", "f32", "int8", "int4"):
        plan = scoring.scan_plan(kind, 16, 768, n, 10)
        assert (plan.qb, plan.groups, plan.ranges, plan.qstream) == (16, 1, 132, False)
    assert scoring.flat_scan_plan(16, 3072, 2048, 10, torch.float32).qstream


def _better(a, b):
    """(score, row) ``a`` before ``b``: score desc, then row asc."""
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


def _merge_by_rank(lst, cands, k):
    """B2's merge: each candidate's place is the count of list entries and
    of other candidates before it; list entries move down by the count of
    candidates before them; places at k or past fall off."""
    out = [None] * k
    for j, e in enumerate(lst):
        p = j + sum(_better(c, e) for c in cands)
        if p < k:
            out[p] = e
    for c in cands:
        p = sum(_better(e, c) for e in lst) + sum(_better(o, c) for o in cands if o is not c)
        if p < k:
            out[p] = c
    return out


def _scan_emulated(scores, k, n_valid, plan, rng, slots=32, per=1):
    """The Hopper scan in plain Python over one query's scores: per range,
    per tile (``per`` logical rows a corpus row: int4's 2), the pre-filter
    against the k-th as of the last merge, survivors to slots in a shuffled
    (fragment) order, a merge when one finds the slots full and at the
    range's end; then pass 2 over the ranges' lists."""
    lists = []
    tile = per * scoring.SCAN_TILE
    for t0, t1 in plan.tile_ranges():
        lst = [(-np.inf, np.iinfo(np.int32).max)] * k
        slot = []
        for t in range(t0, t1):
            rows = np.arange(t * tile, min((t + 1) * tile, len(scores)))
            todo = [(float(scores[r]), int(r)) for r in rng.permutation(rows)
                    if r < n_valid and scores[r] >= lst[-1][0]]
            while todo:
                left = []
                for c in todo:
                    if not _better(c, lst[-1]):
                        continue
                    (slot if len(slot) < slots else left).append(c)
                if not left:
                    break
                lst, slot, todo = _merge_by_rank(lst, slot, k), [], left
        lists += _merge_by_rank(lst, slot, k)
    best = sorted((e for e in lists if e[0] != -np.inf), key=lambda e: (-e[0], e[1]))[:k]
    best += [(-np.inf, 0)] * (k - len(best))
    return (torch.tensor([e[0] for e in best], dtype=torch.float32),
            torch.tensor([e[1] for e in best], dtype=torch.int32))


@pytest.mark.parametrize("n,n_pad,b,k,dup", [
    (3001, 4096, 3, 10, 1),        # n_valid inside a tile
    (4096, 4096, 2, 40, 1),        # k = 40: the first tiles overflow the slots
    (2048, 2048, 2, 10, 32),       # duplicated rows: ties at the boundary
    (5, 4096, 1, 10, 1),           # short results: (-inf, 0)
])
def test_int8_scan_emulation_equals_plain(n, n_pad, b, k, dup):
    """The filter, the slots that merge only when full, the merge by rank
    and pass 2 give int8_flat_search_plain's scores and ids bit for bit,
    whatever order the survivors arrive in."""
    rng = np.random.default_rng(21)
    d = 64
    x = rng.standard_normal((n // dup, d)).astype(np.float32)
    c8, cs = quant.quantize_rows(torch.from_numpy(np.concatenate([x] * dup)))
    c8 = torch.nn.functional.pad(c8, (0, 0, 0, n_pad - n))
    cs = torch.nn.functional.pad(cs, (0, n_pad - n))
    q8, _ = quant.quantize_rows(torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)))
    ps, pi = quant.int8_flat_search_plain(q8, c8, cs, k, n)
    scores = (q8.double() @ c8.double().T).float() * cs[None, :]
    plan = quant.int8_scan_plan(16, d, n_pad, k)._replace(ranges=3)
    for qi in range(b):
        es, ei = _scan_emulated(scores[qi].numpy(), k, n, plan, rng)
        assert torch.equal(es, ps[qi]) and torch.equal(ei, pi[qi])


def _scan_inputs(kind, rng, n, n_pad, b, d, dup):
    """(per-query scores [b, n_pad logical], plain (scores, ids), plan rows,
    logical rows per plan row) for one scan kind."""
    x = rng.standard_normal((n // dup, d)).astype(np.float32)
    x = torch.from_numpy(np.concatenate([x] * dup))
    qf = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    if kind == "int4":
        c4, s4 = quant.quantize_rows_int4(x)
        c4 = torch.nn.functional.pad(c4, (0, 0, 0, n_pad // 2 - c4.shape[0]))
        s4 = torch.nn.functional.pad(s4, (0, n_pad // 2 - s4.shape[1]), value=1.0)
        q8, _ = quant.quantize_rows(qf)
        corr = (8 * q8.to(torch.int32).sum(dim=1)).float()
        full = quant.int4_flat_search_plain(q8, corr, c4, s4, n_pad, n_pad)
        scores = torch.full((b, n_pad), float("-inf"))
        scores.scatter_(1, full[1].long(), full[0])
        return scores, lambda k, nv: quant.int4_flat_search_plain(q8, corr, c4, s4, k, nv), \
            n_pad // 2, 2
    dt = torch.float32 if kind == "f32" else torch.bfloat16
    c = torch.nn.functional.pad(x, (0, 0, 0, n_pad - n)).to(dt)
    q = qf.to(dt)
    scores = q.float() @ c.float().T
    return scores, lambda k, nv: scoring.flat_search_plain(q, c, k, nv), n_pad, 1


@pytest.mark.parametrize("kind", ["int4", "bf16", "f32"])
@pytest.mark.parametrize("n,n_pad,b,k,dup", [
    (3001, 4096, 3, 10, 1),        # n_valid inside a tile (int4: odd, a phantom row)
    (4096, 4096, 2, 40, 1),        # k = 40: the first tiles overflow the slots
    (2048, 2048, 2, 10, 32),       # duplicated rows: ties at the boundary
    (5, 4096, 1, 10, 1),           # short results: (-inf, 0)
])
def test_scan_emulation_equals_plain(kind, n, n_pad, b, k, dup):
    """The shared filter, slots, merge by rank and pass 2 over B3's two
    logical rows per byte-row (a tile of 128 byte-rows holds 256 rows) and
    over B1's bf16 and f32 scores give the plain versions' scores and ids
    bit for bit, whatever order the survivors arrive in."""
    rng = np.random.default_rng(22)
    scores, plain, rows, per = _scan_inputs(kind, rng, n, n_pad, b, 64, dup)
    ps, pi = plain(k, n)
    plan = scoring.scan_plan(kind, 16, 64, rows, k)._replace(ranges=3)
    for qi in range(b):
        es, ei = _scan_emulated(scores[qi].numpy(), k, n, plan, rng, per=per)
        assert torch.equal(es, ps[qi]) and torch.equal(ei, pi[qi])
