"""The port stands alone: ``fedml_tpu_torch`` and ``chip_smoke.py`` import
neither JAX (nor flax/optax) nor anything of the JAX package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "fedml_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "fedml_tpu")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_source_scan_finds_no_forbidden_import():
    """(g) no import statement of the port names a forbidden package."""
    bad = []
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(path.name, a.name) for a in node.names if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                if _forbidden(node.module):
                    bad.append((path.name, node.module))
    assert not bad, bad


def test_importing_every_module_loads_no_jax():
    """(g) in a fresh interpreter, importing every module of the port and
    chip_smoke.py leaves no jax* or fedml_tpu* (other than the port) entry
    in sys.modules."""
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD []" in proc.stdout
    assert len(_modules()) >= 20


def test_chip_smoke_refuses_without_cuda():
    """Without a card, chip_smoke.py exits non-zero and prints no result."""
    if torch.cuda.is_available():
        import pytest

        pytest.skip("this machine has CUDA")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=str(REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
