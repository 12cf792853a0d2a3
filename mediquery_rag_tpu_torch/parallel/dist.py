"""Training meshes on ``torch.distributed``: one process per rank (the
port's own; the JAX trainers run one controller over a ``("data",
"model")`` mesh and let GSPMD insert the collectives).

- ``init_train_mesh(dp, tp)`` names the world's ranks as a 2-D
  ``DeviceMesh`` with dims ``("data", "model")``, rank ``d * tp + m`` (JAX's
  row-major mesh order). The backend is NCCL on the card and gloo on the
  CPU; two ranks that share one card must use gloo (NCCL refuses them).
- ``launch(fn, dp, tp, ...)`` spawns the ``dp * tp`` workers of one run
  (``torch.multiprocessing``, spawn), each calling ``fn(mesh, *args)``.
  They meet through a file store in a temporary directory, so parallel
  runs cannot collide on a port. A worker that fails, dies or outlives
  ``timeout`` kills the others, and the parent raises.
- ``Layout`` is Megatron's tensor-parallel layout of a parameter tree: each
  leaf sharded over ``"model"`` along the dim its partition spec names
  (JAX's axes) holds this rank's positions of that dim: a contiguous run,
  or for a fused ``[q | k | v]`` projection its heads (``head_parts``). Every rank draws the same full parameters
  from the same seed and keeps its part (``shard``); ``gather`` rebuilds
  the full tree in JAX's layout. A position held by several ranks (the KV
  heads of a GQA model when ``kv_heads < tp``) gets the sum of their
  gradients, and counts once in every sum the optimizer takes over the
  whole leaf (``sharded_sum``).

A serving mesh is a ``TrainMesh`` with ``dp == 1``. ``Layout`` also cuts a
QUANTIZED tree (``ops.matvec.quantize_decoder_params``), quantized whole
first, as JAX quantizes: each quantized leaf is cut as its float weight's
spec says, in its own layout. int8 ``{"q": [.., out, in], "s": [.., out]}``:
a column cut (spec on out) takes q's rows and s's entries, a row cut (on
in) takes q's columns and leaves s whole. int4 ``{"q4": [.., out/2, in],
"s": [.., 2, out/2], "t": [.., 1, in]}`` packs channels j and j + out/2 in
one byte, so a column cut unpacks the codes, selects the rank's channels
and repacks them as split halves of the rank's own width, with s re-planed
to match (the codes stay bit-equal; t, JAX's equalizer over the whole in
dim, stays whole); a row cut takes q4's and t's columns and leaves s whole.
``gather`` rebuilds the whole quantized tree bit for bit.
"""

from __future__ import annotations

import math
import os
import queue
import tempfile
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

from mediquery_rag_tpu_torch.ops.matvec import pack_int4, unpack_int4
from mediquery_rag_tpu_torch.parallel import collectives as cc

AXES = ("data", "model")
TIMEOUT_S = 600.0


@dataclass(frozen=True, eq=False)
class TrainMesh:
    """A ``("data", "model")`` device mesh and this rank's device."""

    device_mesh: DeviceMesh
    device: torch.device

    @property
    def dp(self) -> int:
        return self.device_mesh.size(0)

    @property
    def tp(self) -> int:
        return self.device_mesh.size(1)

    @property
    def data_rank(self) -> int:
        return self.device_mesh.get_local_rank("data")

    @property
    def model_rank(self) -> int:
        return self.device_mesh.get_local_rank("model")

    @property
    def data_group(self):
        """The data group, or None when it holds only this rank."""
        return self.device_mesh.get_group("data") if self.dp > 1 else None

    @property
    def model_group(self):
        return self.device_mesh.get_group("model") if self.tp > 1 else None

    def rows(self, n: int) -> slice:
        """This data rank's rows of a global batch of ``n``."""
        check_batch(n, self.dp)
        per = n // self.dp
        return slice(self.data_rank * per, (self.data_rank + 1) * per)


def check_mesh(mesh) -> None:
    """A trainer's mesh is a ``TrainMesh`` (one process per rank), not the
    single-controller ``parallel.mesh.Mesh`` of the sharded indexes."""
    if mesh is not None and not isinstance(mesh, TrainMesh):
        raise TypeError(f"a trainer's mesh is a parallel.dist.TrainMesh (init_train_mesh), "
                        f"got {type(mesh).__name__}")


def check_batch(batch_size: int, dp: int) -> None:
    """A global batch must split evenly over the data axis."""
    if batch_size % dp:
        raise ValueError(f"batch of {batch_size} rows does not split over data axis {dp}")


def resolve_device(device, local_rank: int = 0) -> torch.device:
    """``"cuda"`` (or None) -> ``cuda:<local_rank>``; anything else as given."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_rank)
    return device


def init_train_mesh(dp: int, tp: int, backend: str | None = None, *,
                    device: str | torch.device | None = None, init_method: str | None = None,
                    rank: int | None = None, world_size: int | None = None,
                    timeout: float = TIMEOUT_S) -> TrainMesh:
    """The ``(dp, tp)`` mesh of this process group, joining it first when
    no group exists (``init_method``/``rank``/``world_size``, or a
    launcher's environment). ``device`` defaults to ``cuda:<local rank>``;
    ``backend`` to NCCL for a card and gloo for the CPU."""
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    device = resolve_device(device, int(os.environ.get("LOCAL_RANK", rank)))
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size, timeout=timedelta(seconds=timeout))
    if dp * tp != dist.get_world_size():
        raise ValueError(f"mesh {dp} x {tp} needs {dp * tp} ranks, the group has "
                         f"{dist.get_world_size()}")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = DeviceMesh(kind, torch.arange(dp * tp).reshape(dp, tp), mesh_dim_names=AXES)
    return TrainMesh(mesh, device)


def _worker(rank, world, dp, tp, init, backend, device, timeout, fn, args, results):
    try:
        torch.set_num_threads(1)
        mesh = init_train_mesh(dp, tp, backend, device=resolve_device(device, rank),
                               init_method=init, rank=rank, world_size=world, timeout=timeout)
        results.put((rank, True, fn(mesh, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn, dp: int, tp: int, *args, device: str | torch.device = "cuda",
           timeout: float = TIMEOUT_S) -> list:
    """Run ``fn(mesh, *args)`` (a module-level function) in ``dp * tp``
    spawned processes and return each rank's result, by rank. ``device``
    ``"cuda"`` gives rank r ``cuda:r`` (NCCL); ``"cuda:0"`` puts every rank
    on one card, over gloo, since NCCL refuses two ranks on one card;
    ``"cpu"`` runs gloo on the CPU. Each worker runs torch on one thread."""
    world = dp * tp
    backend = "gloo" if world > 1 and torch.device(device).index is not None else None
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="mesh-") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_worker, daemon=True,
                             args=(r, world, dp, tp, init, backend, str(device), timeout,
                                   fn, args, results)) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(out) < world:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"mesh run past {timeout:.0f} s")
                try:
                    rank, ok, value = results.get(timeout=0.5)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode is not None and r not in out]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode} before reporting")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                out[rank] = value
        except BaseException:
            for p in procs:
                p.kill()
            raise
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(world)]


# -- Megatron's layout of a parameter tree ---------------------------------------

def tree_paths(tree: dict) -> list[tuple[str, ...]]:
    """Leaf key paths in JAX's flatten order (dict keys sorted)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend([(k, *p) for p in tree_paths(v)] if isinstance(v, dict) else [(k,)])
    return out


def tree_get(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def tree_set(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def contiguous_parts(n: int, tp: int) -> list[torch.Tensor]:
    """Rank r's positions of a dim of ``n`` split into ``tp`` runs."""
    if n % tp:
        raise ValueError(f"dim of {n} does not split over model axis {tp}")
    per = n // tp
    return [torch.arange(r * per, (r + 1) * per) for r in range(tp)]


def head_parts(heads: int, kv_heads: int, dh: int, tp: int) -> list[torch.Tensor]:
    """Rank r's columns of a fused ``[q | k | v]`` projection (``heads``
    query heads, ``kv_heads`` each of k and v, ``dh`` wide): its
    ``heads / tp`` query heads and the KV heads they read. With
    ``kv_heads < tp`` a KV head is held by ``tp / kv_heads`` ranks."""
    if heads % tp:
        raise ValueError(f"model axis {tp} does not divide heads {heads}")
    if kv_heads % tp and tp % kv_heads:
        raise ValueError(f"model axis {tp} and kv_heads {kv_heads}: neither divides the other")
    hl, kvl = heads // tp, max(kv_heads // tp, 1)
    g = heads // kv_heads
    parts = []
    for r in range(tp):
        kv0 = r * hl // g
        cols = [torch.arange(r * hl * dh, (r + 1) * hl * dh)]
        for base in (heads * dh, (heads + kv_heads) * dh):
            cols.append(base + torch.arange(kv0 * dh, (kv0 + kvl) * dh))
        parts.append(torch.cat(cols))
    return parts


@dataclass(frozen=True, eq=False)
class LeafShard:
    """This rank's part of one leaf: positions ``parts[rank]`` of dim
    ``dim`` (``full`` long). ``weight``: 1 / (ranks holding it) per held
    position, or None where every position has one holder. ``view``: how a
    quantized leaf shows the cut dim (``""``: as it is; ``"int4_codes"``:
    q4 unpacked to one code row per channel; ``"int4_planes"``: s's two
    planes as one row of channels)."""

    dim: int
    full: int
    parts: tuple
    rank: int
    group: object
    weight: torch.Tensor | None
    view: str = ""

    @property
    def index(self) -> torch.Tensor:
        return self.parts[self.rank]

    def full_shape(self, shape) -> list[int]:
        shape = list(shape)
        shape[self.dim] = self.full
        return shape


def sharded_sum(x: torch.Tensor, s: LeafShard | None, xdim: int | None, dim: int | None = None,
                keepdim: bool = False) -> torch.Tensor:
    """Sum of ``x`` over ``dim`` (None: every dim) as if it were whole:
    ``x``'s dim ``xdim`` holds this rank's part of a leaf split like ``s``
    (``s`` or ``xdim`` None: ``x`` is whole). Positions held by several
    ranks count once; a sum over the split dim is all-reduced over the
    model group (its result is then the same on every rank)."""
    if s is None or xdim is None or (dim is not None and dim % x.ndim != xdim):
        return x.sum() if dim is None else x.sum(dim, keepdim=keepdim)
    if s.weight is not None:
        shape = [1] * x.ndim
        shape[xdim] = -1
        x = x * s.weight.to(x.device).view(shape)
    return cc.all_reduce(x.sum() if dim is None else x.sum(dim, keepdim=keepdim), s.group)


def sharded_mean(x: torch.Tensor, s: LeafShard | None, xdim: int | None,
                 dim: int | None = None, keepdim: bool = False) -> torch.Tensor:
    """``sharded_sum`` divided by the whole tensor's count (``x.mean`` where
    no split dim is reduced)."""
    if s is None or xdim is None or (dim is not None and dim % x.ndim != xdim):
        return x.mean() if dim is None else x.mean(dim, keepdim=keepdim)
    whole = list(x.shape)
    whole[xdim] = s.full
    n = math.prod(whole) if dim is None else whole[dim]
    return sharded_sum(x, s, xdim, dim, keepdim) / n


def quant_form(node) -> str | None:
    """``"int8"`` for a ``{"q", "s"}`` weight, ``"int4"`` for ``{"q4", "s",
    "t"}``, else None."""
    if isinstance(node, dict):
        return {frozenset(("q", "s")): "int8", frozenset(("q4", "s", "t")): "int4"}.get(
            frozenset(node))
    return None


# (form, column cut?, leaf) -> (the leaf's cut dim, its view); absent: whole
_QUANT_CUTS = {
    ("int8", True, "q"): (-2, ""), ("int8", True, "s"): (-1, ""),
    ("int8", False, "q"): (-1, ""),
    ("int4", True, "q4"): (-2, "int4_codes"), ("int4", True, "s"): (-1, "int4_planes"),
    ("int4", False, "q4"): (-1, ""), ("int4", False, "t"): (-1, ""),
}


def _view(t: torch.Tensor, view: str) -> torch.Tensor:
    if view == "int4_codes":
        return unpack_int4(t)
    if view == "int4_planes":
        return t.reshape(*t.shape[:-2], -1)
    return t


def _unview(t: torch.Tensor, view: str) -> torch.Tensor:
    if view == "int4_codes":
        return pack_int4(t)
    if view == "int4_planes":
        return t.reshape(*t.shape[:-1], 2, -1).contiguous()
    return t


class Layout:
    """Per-leaf ``LeafShard`` (None: replicated) of a parameter tree, float
    or quantized, in JAX's leaf order, for one rank of ``mesh``.

    ``specs``: the model's ``partition_specs()`` (a tuple of axis names or
    None per dim, per leaf, in the float layout ``[.., in, out]``; leaves
    missing from it are replicated; a quantized weight's leaves follow its
    float weight's spec); ``parts``: ``{path: per-rank positions}`` for
    weights whose model split is not a contiguous run."""

    def __init__(self, tree: dict, specs: dict, mesh: TrainMesh | None,
                 parts: dict | None = None):
        self.mesh = mesh
        self.paths = tree_paths(tree)
        tp = 1 if mesh is None else mesh.tp
        self.shards: list[LeafShard | None] = []
        for path in self.paths:
            form = quant_form(tree_get(tree, path[:-1])) if len(path) > 1 else None
            weight_path = path[:-1] if form else path
            spec = _spec(specs, weight_path)
            if tp == 1 or spec is None or "model" not in spec:
                self.shards.append(None)
                continue
            dim, view = spec.index("model"), ""
            if form:
                cut = _QUANT_CUTS.get((form, dim == len(spec) - 1, path[-1]))
                if cut is None:
                    self.shards.append(None)
                    continue
                dim, view = cut
            full = _view(tree_get(tree, path), view).shape[dim]
            name = "/".join(weight_path)
            try:
                per_rank = (parts or {}).get(weight_path) or contiguous_parts(full, tp)
            except ValueError as e:
                raise ValueError(f"{name}: {e}") from None
            if view == "int4_codes" and len(per_rank[0]) % 2:
                raise ValueError(f"{name}: int4 packs channel pairs, and a rank's "
                                 f"{len(per_rank[0])} channels are odd (model axis {tp})")
            holders = torch.zeros(full)
            for p in per_rank:
                holders[p] += 1
            own = per_rank[mesh.model_rank]
            weight = None if bool((holders == 1).all()) else (1.0 / holders[own])
            self.shards.append(LeafShard(dim, full, tuple(per_rank), mesh.model_rank,
                                         mesh.model_group, weight, view))

    def shard(self, tree: dict) -> dict:
        """This rank's part of a full tree (new tensors; replicated leaves
        are the given ones)."""
        out: dict = {}
        for path, s in zip(self.paths, self.shards):
            t = tree_get(tree, path)
            if s is not None:
                t = _unview(_view(t, s.view).index_select(s.dim, s.index.to(t.device)),
                            s.view).contiguous()
            tree_set(out, path, t)
        return out

    def gather(self, tree: dict) -> dict:
        """The full tree in JAX's layout from every rank's part (each
        sharded leaf all-gathered over the model group), on every rank."""
        out: dict = {}
        for path, s in zip(self.paths, self.shards):
            tree_set(out, path, gather_leaf(tree_get(tree, path).detach(), s))
        return out

    def reduce_grads(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """The full step's gradients from this rank's: positions held by
        several model ranks get their holders' sum, then every gradient is
        summed over the data group."""
        grads = [g if s is None or s.weight is None else _sum_holders(g, s)
                 for g, s in zip(grads, self.shards)]
        return cc.all_reduce_flat(grads, None if self.mesh is None else self.mesh.data_group)


def gather_leaf(t: torch.Tensor, s: LeafShard | None) -> torch.Tensor:
    """The whole leaf from every model rank's part ``t`` (``s`` None: ``t``)."""
    if s is None:
        return t
    local = _view(t, s.view)
    parts = cc.all_gather(local.contiguous(), s.group)
    full = local.new_zeros(s.full_shape(local.shape))
    for p, idx in zip(parts, s.parts):
        full.index_copy_(s.dim, idx.to(t.device), p)
    return _unview(full, s.view)


def _sum_holders(g: torch.Tensor, s: LeafShard) -> torch.Tensor:
    full = g.new_zeros(s.full_shape(g.shape))
    full.index_add_(s.dim, s.index.to(g.device), g)
    return cc.all_reduce(full, s.group).index_select(s.dim, s.index.to(g.device))


def _spec(specs: dict, path: tuple):
    node = specs
    for k in path:
        if not isinstance(node, dict) or k not in node:
            return None
        node = node[k]
    return node
