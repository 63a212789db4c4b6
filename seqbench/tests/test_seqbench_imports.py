"""Nothing under seqbench/ imports JAX or the JAX package (each module's
top-level name compared whole: the port's name begins with the JAX
package's), the reference imports nothing of the program, and nothing
reads the JAX-era benchmark files."""

import ast
import pathlib
import subprocess
import sys

import harness

HERE = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "cse305_parallel_sequence_alignment_tpu"}
PROGRAM = "cse305_parallel_sequence_alignment_torch"
OLD_FILES = ("bench.py", "BENCH_r", "MULTICHIP_r", "BASELINE.json")


def imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def test_no_module_imports_jax():
    for path in SOURCES:
        assert not imported(path) & FORBIDDEN, path


def test_forbidden_names_are_whole_top_level_names():
    assert set(harness.FORBIDDEN) == FORBIDDEN
    assert PROGRAM.split(".")[0] not in FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in sorted((HERE / "reference").glob("*.py")):
        assert PROGRAM not in imported(path), path
        assert "cse305" not in path.read_text(), path


def test_nothing_reads_the_old_benchmark_files():
    for path in sorted(p for p in HERE.rglob("*") if p.is_file()
                       and "__pycache__" not in p.parts
                       and p.suffix in (".py", ".json")):
        text = path.read_text()
        if path.parent.name == "tests":
            continue
        for old in OLD_FILES:
            assert old not in text, (path, old)


def test_a_run_loads_no_jax():
    """A small CPU run in a fresh process leaves no JAX module loaded."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import harness\n"
        "r = harness.run('dna-genes-batch', 3, 0.0, False, device='cpu',"
        " scale=0.005, max_items=4, log=lambda s: None)\n"
        "assert r['correct'], r\n"
        "print(harness.forbidden_modules())\n") % (str(HERE),
                                                     str(HERE.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
