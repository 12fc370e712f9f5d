"""The check that nothing the benchmark runs loads JAX or the JAX package.
Module names are compared by their whole top-level part (before the
first dot): the port's package name begins with the JAX package's."""

from __future__ import annotations

import ast
import pathlib
import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "software_rasterizer_tpu"})


def top(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules: Iterable[str] = None) -> List[str]:
    """The loaded modules (default: `sys.modules`) whose top-level name is
    forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in list(names) if top(n) in FORBIDDEN)


def forbidden_imports(root: pathlib.Path) -> List[str]:
    """`file: module` for every import under `root` whose top-level name
    is forbidden (absolute imports; a relative one stays inside)."""
    found = []
    for path in sorted(root.rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            else:
                continue
            found += [f"{path}: {n}" for n in names if top(n) in FORBIDDEN]
    return found
