"""The port stands alone: no module of qlora_tpu_torch/, and not
chip_smoke.py, imports jax, flax or the JAX package (qlora_tpu)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "flax", "optax", "qlora_tpu")
FILES = sorted((ROOT / "qlora_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in BANNED]
    assert not bad, f"{path.name} imports {bad}"


def test_scan_covers_the_port():
    assert len(FILES) > 10 and (ROOT / "chip_smoke.py").exists()
