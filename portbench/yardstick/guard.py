"""What the benchmark must never load: JAX, and the JAX package and its
drop-in namespace beside the port.  Names are compared by their whole
top-level part (before the first dot): the port's own name,
``libertem_tpu_torch``, begins with ``libertem_tpu`` and is none of
them."""
from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "libertem_tpu", "libertem"})
PROGRAM = "libertem_tpu_torch"


def top(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules=None) -> list:
    """The forbidden top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    return sorted({top(n) for n in names} & FORBIDDEN)


def imported_names(path: Path) -> set:
    """The top-level names that the Python source ``path`` imports
    (absolute imports; a relative one names nothing outside its
    folder)."""
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(top(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(top(node.module))
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            out.add(top(str(node.args[0].value)))
    return out
