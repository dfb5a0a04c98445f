"""Nothing the benchmark runs imports JAX, the JAX package or its
drop-in namespace (top-level names compared whole: the port's
``libertem_tpu_torch`` begins with ``libertem_tpu``), and the plain
reference imports nothing of the program."""
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from yardstick import guard  # noqa: E402

SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_forbidden_import(path):
    names = guard.imported_names(path)
    assert not names & guard.FORBIDDEN, path
    if "reference" in path.relative_to(BENCH).parts:
        assert guard.PROGRAM not in names, path


def test_names_are_compared_whole():
    assert guard.loaded_forbidden(
        ["libertem_tpu_torch", "libertem_tpu_torch.udf.base", "jaxtyping",
         "numpy"]) == []
    assert guard.loaded_forbidden(
        ["libertem.api", "libertem_tpu", "jaxlib.xla_client", "flax"]) == [
        "flax", "jaxlib", "libertem", "libertem_tpu"]


def test_import_scan_sees_every_form(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "import jax.numpy as jnp\nfrom libertem_tpu import api\n"
        "from . import sibling\nimport importlib\n"
        "importlib.import_module('libertem.udf')\n"
        "import libertem_tpu_torch\n")
    assert guard.imported_names(src) == {
        "jax", "libertem_tpu", "importlib", "libertem", "libertem_tpu_torch"}
