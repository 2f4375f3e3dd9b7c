"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and the kernels' build
directory is never committed."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"chip_smoke.py", "simulator.py", "engine.py", "delivery.py",
            "lif_update.py", "ell_deliver.py", "lif_deliver.py",
            "convert.py", "plasticity.py", "stdp.py",
            "spike_deliver.py", "flash_attention.py", "layers.py",
            "experiment.py", "checkpointer.py", "reference.py",
            "report.py", "stats.py", "compile_cache.py", "session.py",
            "batching.py", "http.py", "sanitize.py", "__main__.py",
            "graph_cache.py", "distributed.py", "mesh.py", "lint.py",
            "graph_contract.py", "step_analysis.py", "dryrun.py",
            "rules.py", "ctx.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported_modules(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_kernel_build_dir_is_ignored():
    lines = [ln.strip() for ln in (ROOT / ".gitignore").read_text()
             .splitlines()]
    assert any(ln.rstrip("/") in ("build/kernels", "/build/kernels", "build")
               for ln in lines)
