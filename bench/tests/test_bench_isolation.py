"""Nothing under bench/ imports JAX or the JAX package (top-level module
names compared whole: the port's name begins with the JAX package's), and
the yardstick, the reference above all, imports nothing of the program."""
import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# the files that may not reach the program: the reference, the inputs, the
# counters and the trace arithmetic
YARDSTICK = ("reference.py", "weights.py", "traffic.py", "counters.py",
             "trace.py", "check.py")


def _top_imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_jax_anywhere_in_bench():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        found = _top_imports(f) & FORBIDDEN
        assert not found, f"{f} imports {found}"


def test_the_yardstick_imports_nothing_of_the_program():
    for name in YARDSTICK:
        imports = _top_imports(BENCH / name)
        assert "repro_torch" not in imports, name
        assert imports <= {"__future__", "dataclasses", "json", "math",
                           "pathlib", "statistics", "typing", "zlib",
                           "numpy", "torch", "bench"}, (name, imports)
    ref = _top_imports(BENCH / "reference.py")
    assert ref <= {"__future__", "dataclasses", "math", "torch"}


def test_the_reference_never_reads_the_program_at_run_time():
    import sys
    import subprocess
    code = ("import sys; sys.path.insert(0, %r); import bench.reference, "
            "bench.weights, bench.traffic, bench.counters, bench.check, "
            "bench.trace; print(sorted({m.split('.')[0] for m in "
            "sys.modules} & {'repro_torch', 'repro', 'jax'}))"
            % str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"
