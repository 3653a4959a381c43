"""Nothing the harness loads is jax or the JAX package: by the AST of every
file under benchmark/, and by sys.modules after a whole run. Top-level
module names are compared whole (the port's own name starts with the JAX
package's)."""

from __future__ import annotations

import ast
import subprocess
import sys

from benchmark.harness import core

FORBIDDEN = set(core.FORBIDDEN_MODULES)


def _roots(path) -> set:
    tree = ast.parse(path.read_text(), str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
              and path.parent.name != "tests"):
            # A module named in a string (a CorDapp, `python -m`).
            word = node.value.split(".")[0]
            if node.value.count(".") and word in FORBIDDEN:
                roots.add(word)
    return roots


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    files = sorted(core.BENCH.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        assert not _roots(path) & FORBIDDEN, path


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "corda_tpu_torch_lookalike", sys)
    assert "corda_tpu_torch_lookalike" not in core.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "corda_tpu.fake", sys)
    assert core.forbidden_loaded() == ["corda_tpu.fake"]


def test_a_whole_run_loads_neither():
    code = (
        "import sys; sys.path[0] = %r\n"
        "from benchmark.tests.helpers import run_tiny\n"
        "from benchmark.harness import core\n"
        "if __name__ == '__main__':\n"
        "    r = run_tiny('firehose.bulk')\n"
        "    assert r['correct'], r\n"
        "    print('LOADED', core.forbidden_loaded())\n" % str(core.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout


def test_the_command_fails_without_a_card():
    out = subprocess.run(
        [sys.executable, str(core.BENCH / "run.py"), "--workload",
         "firehose.bulk", "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
