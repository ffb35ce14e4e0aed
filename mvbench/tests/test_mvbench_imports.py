"""Nothing under mvbench/ imports JAX or the JAX package, and the
reference imports nothing of the program; top-level names compared
whole (the port's name begins with the JAX package's)."""

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
JAX_NAMES = {"jax", "jaxlib", "flax", "stereo_to_multiview_tpu"}
PORT = "stereo_to_multiview_tpu_torch"


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def sources():
    return sorted(BENCH.rglob("*.py"))


def test_the_scan_sees_every_form(tmp_path):
    tree = ("import jax.numpy\nfrom stereo_to_multiview_tpu.ops import x\n"
            "import importlib\nimportlib.import_module('flax.linen')\n"
            "from stereo_to_multiview_tpu_torch import kernels\n")
    p = tmp_path / "probe.py"
    p.write_text(tree)
    got = top_level_imports(p)
    assert {"jax", "stereo_to_multiview_tpu", "flax", PORT} <= got
    assert PORT not in JAX_NAMES and PORT.startswith("stereo_to_multiview_tpu")


def test_no_module_imports_jax_or_the_jax_package():
    assert sources()
    for path in sources():
        bad = top_level_imports(path) & JAX_NAMES
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    ref = sorted((BENCH / "reference").rglob("*.py"))
    assert ref
    for path in ref:
        names = top_level_imports(path)
        assert PORT not in names and "mvbench" not in names, path
