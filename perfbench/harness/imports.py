"""The check that nothing the benchmark runs brings in JAX or the JAX
package. Module names are compared by their top-level name (the part
before the first dot) whole: the port's package name begins with the JAX
package's, and is allowed."""

from __future__ import annotations

import ast
import os
import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "mediquery_rag_tpu"})
PROGRAM = "mediquery_rag_tpu_torch"


def top(name: str) -> str:
    return name.split(".", 1)[0]


def loaded() -> list[str]:
    """Forbidden top-level modules present in this process."""
    return sorted({top(n) for n in list(sys.modules)} & FORBIDDEN)


def imported_by(path: str) -> set[str]:
    """Top-level names of every module a source file imports, at any depth
    of its code (relative imports are the benchmark's own)."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(top(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(top(node.module))
    return out


def sources(root: str) -> list[str]:
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
                  if f.endswith(".py"))
