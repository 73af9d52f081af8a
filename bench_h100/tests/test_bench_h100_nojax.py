"""Nothing of JAX or of the JAX package runs in the benchmark: the
check compares top-level module names whole, and the reference imports
neither the program nor JAX."""

import ast
import sys
import types

import pytest

from bench_h100 import common
from bench_h100.run import report


def test_top_level_names_are_compared_whole():
    assert common.forbidden_loaded({"stnls_tpu_torch": 1,
                                    "stnls_tpu_torch.ops": 1,
                                    "jaxtyping": 1, "torch": 1}) == []
    assert common.forbidden_loaded({"stnls_tpu": 1}) == ["stnls_tpu"]
    assert common.forbidden_loaded({"stnls_tpu.ops.nls": 1}) == \
        ["stnls_tpu.ops.nls"]
    assert common.forbidden_loaded({"jax": 1, "jax.numpy": 1}) == \
        ["jax", "jax.numpy"]
    assert common.forbidden_loaded({"jaxlib": 1, "flax.linen": 1}) == \
        ["flax.linen", "jaxlib"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_the_reference_imports_neither_the_program_nor_jax():
    files = sorted((common.HERE / "reference").glob("*.py"))
    assert files
    for path in files:
        for name in _imports(path):
            top = name.split(".", 1)[0]
            assert top not in ("jax", "jaxlib", "flax", "stnls_tpu",
                               "stnls_tpu_torch"), (path.name, name)


def test_no_benchmark_file_imports_jax():
    for path in sorted(common.HERE.rglob("*.py")):
        for name in _imports(path):
            assert name.split(".", 1)[0] not in ("jax", "jaxlib", "flax",
                                                 "stnls_tpu"), \
                (path.name, name)


def test_no_result_is_printed_once_jax_is_loaded(monkeypatch, capsys):
    result = {"correct": True, "compared": {"out_err": {"value": 0.,
                                                        "limit": 1.}}}
    report(result)
    assert capsys.readouterr().out.strip().startswith("{")
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    with pytest.raises(SystemExit) as ended:
        report(result)
    assert ended.value.code != 0
    out, err = capsys.readouterr()
    assert out == "" and "jax.numpy" in err
