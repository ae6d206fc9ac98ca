"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (the port's own name begins with the JAX
package's), and the reference loads nothing of the port."""
import ast
import subprocess
import sys
from pathlib import Path

from portbench_tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "hydrolim_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path.insert(0, {str(ROOT)!r}); {code}; "
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_run_and_a_dry_run_load_no_jax():
    code = ("sys.path.insert(0, " + repr(str(Path(__file__).parent)) + "); "
            "import portbench.run, portbench.control; "
            "from portbench_tiny import tiny_run; "
            "tiny_run('xeng.pde'); tiny_run('xeng.particle')")
    mods = _loaded(code)
    assert "hydrolim_tpu_torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    mods = _loaded("import portbench.reference.meanfield, "
                   "portbench.reference.pde, portbench.reference.philox")
    assert not mods & (FORBIDDEN | {"hydrolim_tpu_torch"})


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {
                    "hydrolim_tpu_torch"}, (path.name, n)
