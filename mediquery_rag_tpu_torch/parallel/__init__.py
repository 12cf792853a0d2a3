"""Device meshes and the cross-shard top-k merge (port of
``mediquery_rag_tpu/parallel``).

One process holds one shard per mesh device; each shard's scan returns a
``[B, kp]`` partial list on its device, and the merge copies those small
lists to one device and reduces them there."""

from mediquery_rag_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, corpus_mesh, make_mesh, slice_mesh,
)
from mediquery_rag_tpu_torch.parallel.collectives import (  # noqa: F401
    grouped_topk_merge, hierarchical_topk_merge, sharded_topk_merge,
)
