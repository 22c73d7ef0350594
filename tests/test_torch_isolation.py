"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the reference package, and ``chip_smoke.py`` fails (with no
result line) without a card or without the rest of the repository."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_BLOCKER = r"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None
sys.meta_path.insert(0, Block())
"""


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PORT)], prefix="repro_torch."))


def test_every_module_is_listed():
    mods = _port_modules()
    for name in ("repro_torch.kernels.hist_select", "repro_torch.fed.loop",
                 "repro_torch.core.wire", "repro_torch.models.paper_models",
                 "repro_torch.core.ingest", "repro_torch.kernels.wiredecode",
                 "repro_torch.kernels.topk_threshold",
                 "repro_torch.kernels.bitpack", "repro_torch.fed.arrivals",
                 "repro_torch.core.residual", "repro_torch.core.protocols",
                 "repro_torch.core.compression", "repro_torch.core.adaptive",
                 "repro_torch.core.chunking"):
        assert name in mods


def test_imports_without_jax_or_reference():
    code = _BLOCKER + f"""
import importlib
for name in {_port_modules()!r}:
    importlib.import_module(name)
sys.path.insert(0, {str(ROOT)!r})
import chip_smoke
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")]
assert not bad, bad
print("clean")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|repro)\b(?!_)",
                     re.MULTILINE)
_QUALIFIED = re.compile(r"\brepro\.\w")


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]))
def test_sources_name_no_reference_module(path):
    src = (ROOT / path).read_text()
    assert not _IMPORT.search(src), path
    assert not _QUALIFIED.search(src), (path, _QUALIFIED.search(src))


def test_qualified_pattern_spares_the_port():
    assert not _QUALIFIED.search("from repro_torch.core import wire")
    assert _QUALIFIED.search("x = repro.core.wire")
    assert _IMPORT.search("import jax.numpy as jnp")
    assert not _IMPORT.search("import repro_torch")


def _run_smoke(cwd: Path):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin",
                               "CUDA_VISIBLE_DEVICES": ""})


def test_chip_smoke_fails_without_a_card():
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
