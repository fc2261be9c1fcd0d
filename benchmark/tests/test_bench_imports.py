"""Nothing under benchmark/ imports JAX, the JAX package, bench.py,
chip_smoke.py or experiments/; only the drivers, the per-layer readers and
the tests that hold the reference to the port import the port; the
reference, the yardstick (`lib/`) and the tools import nothing of it.  Top-level module
names are compared whole: `nasrec_tpu_torch` begins with the letters of
`nasrec_tpu`."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "nasrec_tpu", "bench", "chip_smoke", "experiments"}
PORT = "nasrec_tpu_torch"
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_imports(path):
    names = top_level_imports(path)
    assert not names & FORBIDDEN, names & FORBIDDEN
    rel = path.relative_to(BENCH).parts
    if PORT in names:
        assert rel[0] in ("drivers", "metrics", "tests"), f"{path} imports the port"


def test_whole_name_compare():
    """The port's name is no match for the JAX package's."""
    assert "nasrec_tpu_torch.models".split(".")[0] not in FORBIDDEN
    assert "nasrec_tpu.models".split(".")[0] in FORBIDDEN
