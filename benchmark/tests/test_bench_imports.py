"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level name; the reference loads nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

from benchmark import harness

CHILD = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark import harness
from benchmark.tests._tiny import TINY
harness.run_cell({cell!r}, 9, 0.0, False, "cpu", overrides=TINY)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules_after(code):
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=harness.ROOT))
    assert p.returncode == 0, p.stderr[-2000:]
    import json
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_runs_load_no_jax():
    for cell in ("room0.mapping", "room0.closure"):
        tops = _modules_after(CHILD.format(root=harness.ROOT, cell=cell))
        assert "mneslam_tpu_torch" in tops
        assert not tops & set(harness.FORBIDDEN), tops & set(
            harness.FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "mneslam_tpu_torch_like", sys)
    assert "mneslam_tpu_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "mneslam_tpu.sub", sys)
    assert "mneslam_tpu.sub" in harness.forbidden_modules()


def test_reference_imports_nothing_of_the_program():
    code = ("import json, sys\nsys.path.insert(0, %r)\n"
            "import benchmark.reference.mapping, benchmark.reference.closure"
            "\nprint(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))" % harness.ROOT)
    tops = _modules_after(code)
    assert "mneslam_tpu_torch" not in tops and "mneslam_tpu" not in tops
    for path in glob.glob(os.path.join(harness.HERE, "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                assert not node.module.startswith("mneslam"), path
            if isinstance(node, ast.Import):
                assert not any(a.name.startswith("mneslam")
                               for a in node.names), path
