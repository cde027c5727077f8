"""Nothing under qpbench/ imports JAX or the JAX package (top-level names
compared whole: the port's own name begins with the JAX package's), and
the reference imports nothing of the program."""

import ast
import subprocess
import sys

from qpbench import harness

PORT = "qpnet_tpu_torch"


def imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def modules():
    return sorted((harness.ROOT / "qpbench").rglob("*.py"))


def test_no_module_imports_jax_or_the_jax_package():
    assert modules()
    for path in modules():
        bad = set(imports(path)) & set(harness.FORBIDDEN)
        assert not bad, f"{path} imports {bad}"


def test_top_level_names_compared_whole():
    assert "qpnet_tpu" in harness.FORBIDDEN
    assert PORT.split(".")[0] not in harness.FORBIDDEN
    sys.modules.setdefault("qpnet_tpu_torch_probe", object())
    try:
        assert "qpnet_tpu" not in harness.forbidden_loaded() or \
            "qpnet_tpu" in {m.split(".")[0] for m in sys.modules}
    finally:
        del sys.modules["qpnet_tpu_torch_probe"]


def test_reference_imports_nothing_of_the_program():
    for path in (harness.ROOT / "qpbench" / "reference").rglob("*.py"):
        names = set(imports(path))
        assert PORT not in names, path
        assert names <= {"__future__", "math", "numpy", "torch", "qpbench"}, \
            (path, names)
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("qpbench"):
                assert node.module.startswith("qpbench.reference"), path


def test_a_run_loads_neither():
    """A whole tiny run in a process where importing JAX or the JAX
    package fails: it runs, and nothing forbidden is loaded after it."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'qpnet_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from qpbench.tests import tiny\n"
        "from qpbench import harness\n"
        "run = tiny.run('default.decode.b20', seconds=0.2)\n"
        "for m in ('jax', 'jaxlib', 'flax', 'qpnet_tpu'):\n"
        "    del sys.modules[m]\n"
        "assert run.correct, run.checks\n"
        "assert harness.forbidden_loaded() == [], harness.forbidden_loaded()\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(harness.ROOT), timeout=300)
    assert res.stdout.strip().endswith("ok"), res.stderr[-3000:]
