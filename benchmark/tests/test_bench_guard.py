"""No module of the benchmark imports JAX, Flax, optax or the JAX
package, and the reference imports nothing of the program under test:
every import's top-level name, compared whole."""
import ast
import json
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "storygen_tpu"}
MODULES = sorted(HERE.rglob("*.py"))


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            yield node.args[0].value.split(".", 1)[0]


def test_the_modules_are_found():
    names = {p.relative_to(HERE).as_posix() for p in MODULES}
    assert {"run.py", "reference/sd15_vlcm.py", "trace.py"} <= names


@pytest.mark.parametrize("path", MODULES,
                         ids=lambda p: p.relative_to(HERE).as_posix())
def test_no_jax(path):
    found = set(top_level_imports(path)) & FORBIDDEN
    assert not found, f"{path} imports {sorted(found)}"


@pytest.mark.parametrize(
    "path", sorted((HERE / "reference").rglob("*.py")),
    ids=lambda p: p.relative_to(HERE).as_posix())
def test_the_reference_imports_nothing_of_the_program(path):
    found = set(top_level_imports(path)) & (FORBIDDEN
                                            | {"storygen_tpu_torch"})
    assert not found, f"{path} imports {sorted(found)}"


def test_the_guard_compares_whole_names():
    """storygen_tpu_torch starts with storygen_tpu but is not it."""
    assert "storygen_tpu_torch".split(".", 1)[0] not in FORBIDDEN


def test_a_run_that_loads_jax_in_its_check_prints_no_result(monkeypatch,
                                                           capsys):
    """The look for JAX also follows the check: JAX loaded by the check
    (after the window closed) gives exit code 3 and no result line."""
    import sys
    import types

    from benchmark.run import report
    from benchmark.tests.runs import cpu_run
    run = cpu_run("story-frame-noref-b8")
    check = run.kind.check

    def loads_jax(numerics):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return check(numerics)
    monkeypatch.setattr(run.kind, "check", loads_jax)
    line = run.run()
    assert run.forbidden == ["jax"]
    capsys.readouterr()
    assert report(run, line) == 3
    out = capsys.readouterr()
    assert out.out == "" and "['jax']" in out.err


def test_a_clean_run_prints_its_result_last(capsys):
    from benchmark.run import report
    from benchmark.tests.runs import cpu_run
    run = cpu_run("story-frame-noref-b8")
    line = run.run()
    capsys.readouterr()
    assert report(run, line) == 0
    out = capsys.readouterr()
    assert json.loads(out.out.strip().splitlines()[-1]) == line
    assert out.err.strip().splitlines()[-1].startswith("check image_rel")
