"""Nothing of the benchmark imports JAX or the JAX package (top-level names
compared whole), and the reference imports nothing of the program."""
import ast
from pathlib import Path

import pytest

from h100_bench import run, spec

FILES = sorted(p for p in spec.HERE.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(spec.HERE)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & set(run.FORBIDDEN)


@pytest.mark.parametrize("path", [p for p in FILES if "reference" in p.parts],
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & {"rtfs_net_tpu_torch", "rtfs_net_tpu", "h100_bench"}
    source = path.read_text()
    assert "rtfs_net_tpu" not in source.replace("rtfs_net_tpu_torch", "")


@pytest.mark.parametrize("config", [c["name"] for c in spec.load_benchmark()["configs"]])
def test_every_configuration_names_a_reference_the_scan_covers(config):
    """A committed configuration's reference module lies in ``reference/``,
    so the two tests above read it."""
    path = spec.ROOT / spec.reference_files(config)["reference"]
    assert path in FILES and path.parent == spec.HERE / "reference"


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "rtfs_net_tpu_torch_lookalike", types.ModuleType("x"))
    assert run.forbidden_modules() == [] or "rtfs_net_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "optax.tree", types.ModuleType("optax.tree"))
    assert "optax" in run.forbidden_modules()
