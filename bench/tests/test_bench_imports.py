"""Nothing the benchmark runs loads JAX or the JAX package ``repro``
(top-level module names compared whole: ``repro_torch`` is the program),
the reference imports nothing of the program, and no file of the
benchmark reads ``benchmarks/``."""

import ast
import os
import subprocess
import sys

from bench import manifest, run

FILES = sorted(p for p in manifest.BENCH.rglob("*.py")
               if "tests" not in p.parts)


def _top_imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_file_imports_jax_or_the_jax_package():
    assert len(FILES) > 20
    for p in FILES:
        assert not _top_imports(p) & set(run.FORBIDDEN), p
    # the comparison is of whole names
    assert "repro_torch" not in run.FORBIDDEN


def _bench_imports(path):
    """The benchmark's modules ``path`` imports, by full name."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names
                    if a.name.split(".")[0] == "bench"}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module == "bench":
                out |= {"bench." + a.name for a in node.names}
            elif node.module.split(".")[0] == "bench":
                out.add(node.module)
        elif isinstance(node, ast.ImportFrom):
            out.add("relative import")
    return out


def test_the_reference_imports_nothing_of_the_program():
    """An architecture file takes nothing of the program, and of the
    benchmark only the yardstick's counts, which import neither."""
    for p in (manifest.BENCH / "reference").glob("*.py"):
        assert "repro_torch" not in _top_imports(p), p
        assert _bench_imports(p) <= {"bench.counts"}, p
    assert not _top_imports(manifest.BENCH / "counts.py") & {
        "repro_torch", "bench"}


def test_nothing_reads_the_old_benchmarks():
    for p in FILES + [manifest.ROOT / "BENCHMARK.json"]:
        assert "benchmarks/" not in p.read_text(), p


def test_a_run_leaves_no_forbidden_module_loaded():
    """A whole run at CPU size in a fresh interpreter, then its
    ``sys.modules`` by top-level name."""
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from bench.tests import small\n"
            "from bench import run\n"
            "small.run('granite-34b.completion', seconds=0.5)\n"
            "print(run.forbidden_loaded())\n"
            % (str(manifest.ROOT / "src"), str(manifest.ROOT)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env,
                         cwd=str(manifest.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert run.forbidden_loaded() == [] or "jax" in sys.modules
