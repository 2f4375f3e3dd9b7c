"""Nothing the benchmark runs imports JAX, the JAX package or the old
``benchmarks/`` folder (top-level names compared whole: ``repro_torch``
is the port, ``repro`` the JAX package), and the plain reference imports
nothing of the port either, through any module of ``perfbench`` it
reaches.  Imports are read from each module's file; the network modules
(``perfbench/networks/``), which the harness loads by path, are walked
from their own files."""
import ast
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
FILES = sorted(p for p in PB.rglob("*.py") if "tests" not in p.parts)


def imports(path: Path) -> set:
    """The modules ``path`` imports, anywhere in it (top level, functions,
    ``importlib`` calls with a constant name)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            out.add(node.module)
            out.update(f"{node.module}.{a.name}" for a in node.names)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value))
    return out


def module_file(name: str):
    """The file of a ``perfbench`` module, or None for another package."""
    parts = name.split(".")
    if parts[0] != "perfbench":
        return None
    base = ROOT.joinpath(*parts)
    for cand in (base.with_suffix(".py"), base / "__init__.py"):
        if cand.is_file():
            return cand
    return None


def reached(path: Path) -> set:
    """Every module ``path`` imports, through the ``perfbench`` modules it
    reaches."""
    seen, todo, names = set(), [path], set()
    while todo:
        p = todo.pop()
        if p in seen:
            continue
        seen.add(p)
        for name in imports(p):
            names.add(name)
            f = module_file(name)
            if f is not None:
                todo.append(f)
    return names


def test_files_found():
    names = {str(p.relative_to(PB)) for p in FILES}
    assert {"run.py", "bench.py", "netgen.py", "check.py", "trace.py",
            "roofline.py", "control.py", "faults.py", "program.py",
            "reference/lif_net.py", "reference/pd14.py", "networks/pd14.py",
            "metrics/rtf.py", "metrics/setup_s.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package(path):
    bad = sorted(n for n in reached(path) if n.split(".")[0] in FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} reaches {bad}"


@pytest.mark.parametrize("path", sorted((PB / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    bad = sorted(n for n in reached(path)
                 if n.split(".")[0] in FORBIDDEN | {"repro_torch"})
    assert not bad, f"{path.relative_to(ROOT)} reaches {bad}"


def test_loaded_jax_is_found_by_whole_name(monkeypatch):
    """The run's own look at ``sys.modules`` once the window has closed:
    ``repro`` is the JAX package, ``repro_torch`` the port."""
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import bench
    for name in ("repro_torch_like", "jaxtyping", "repro.core"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = set(bench.forbidden_modules())
    assert "repro.core" in found
    assert not {"repro_torch_like", "jaxtyping"} & found


def test_the_walk_sees_through_modules(tmp_path):
    """The walk follows a ``perfbench`` import to its file: PD14's network
    module reaches the port through ``netgen``, and its reference."""
    names = reached(PB / "networks" / "pd14.py")
    assert {"repro_torch.core.connectivity", "perfbench.reference.lif_net",
            "perfbench.check"} <= names
    assert "repro" not in {n.split(".")[0] for n in names}
