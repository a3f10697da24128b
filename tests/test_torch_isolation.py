"""The port stands alone: no file of ``repro_torch``, of ``examples_torch``
or ``chip_smoke.py`` imports JAX or the JAX package, and every module and
example imports in a process where ``jax``, the JAX package and
``ml_dtypes`` (a JAX dependency) cannot be imported at all."""
import os
import re
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro|ml_dtypes)(\.|\s|$)",
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
        "sys.modules['ml_dtypes'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "loaded = [k for k, v in sys.modules.items() if v is not None]\n"
        "assert 'jax' not in loaded and 'ml_dtypes' not in loaded\n"
        "print(' '.join(names))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 20
    assert {"repro_torch.core.abft_gemm", "repro_torch.core.decoupled",
            "repro_torch.models.transformer", "repro_torch.train.step",
            "repro_torch.optim.adamw", "repro_torch.ft_runtime.checkpoint",
            "repro_torch.data.pipeline", "repro_torch.distributed.context",
            "repro_torch.distributed.mesh",
            "repro_torch.distributed.sharding",
            "repro_torch.distributed.collectives",
            "repro_torch.launch.mesh", "repro_torch.launch.dryrun",
            "repro_torch.utils.opcount"} <= names


EXAMPLES = SRC.parent / "examples_torch"


def test_no_jax_or_reference_imports_in_examples_or_chip_smoke():
    files = sorted(EXAMPLES.glob("*.py")) + [SRC.parent / "chip_smoke.py"]
    assert len(files) == 6
    offenders = []
    for f in files:
        text = f.read_text()
        for m in FORBIDDEN.finditer(text):
            line = text[:m.start()].count("\n") + 1
            offenders.append(f"{f.name}:{line}")
    assert not offenders, offenders


def test_every_example_imports_without_jax():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        f"sys.path.insert(0, {str(EXAMPLES)!r})\n"
        "names = sys.argv[1:]\n"
        "for n in names:\n"
        "    assert callable(importlib.import_module(n).main)\n"
        "loaded = [k for k, v in sys.modules.items() if v is not None]\n"
        "assert 'jax' not in loaded and 'ml_dtypes' not in loaded\n"
        "print(' '.join(names))\n")
    names = sorted(f.stem for f in EXAMPLES.glob("*.py"))
    assert names == ["fault_injection_campaign", "paged_prefix_serving",
                     "quickstart", "serve_fault_tolerant",
                     "train_with_restart"]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code, *names], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == names


EXPERIMENTS = SRC.parent / "experiments_torch"


def test_no_jax_or_reference_imports_in_experiments():
    files = sorted(EXPERIMENTS.glob("*.py"))
    assert [f.name for f in files] == ["hillclimb.py", "render_experiments.py"]
    offenders = []
    for f in files:
        text = f.read_text()
        for m in FORBIDDEN.finditer(text):
            line = text[:m.start()].count("\n") + 1
            offenders.append(f"{f.name}:{line}")
    assert not offenders, offenders


def test_experiments_import_without_jax():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        f"sys.path.insert(0, {str(EXPERIMENTS)!r})\n"
        "for n in ('hillclimb', 'render_experiments'):\n"
        "    assert callable(importlib.import_module(n).main)\n"
        "loaded = [k for k, v in sys.modules.items() if v is not None]\n"
        "assert 'jax' not in loaded and 'ml_dtypes' not in loaded\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok"]
