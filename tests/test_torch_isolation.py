"""The port stands alone: no file of ``repro_torch`` imports JAX or the JAX
package, and every module imports in a process where ``jax`` cannot be
imported at all."""
import os
import re
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)",
                       re.MULTILINE)


def test_no_jax_or_reference_imports_in_the_port():
    files = sorted(PKG.rglob("*.py"))
    assert files
    offenders = []
    for f in files:
        for m in FORBIDDEN.finditer(f.read_text()):
            line = f.read_text()[:m.start()].count("\n") + 1
            offenders.append(f"{f.relative_to(SRC)}:{line}")
    assert not offenders, offenders


def test_every_module_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'jax' not in [k for k, v in sys.modules.items() "
        "if v is not None]\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
