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
                 "repro_torch.core.chunking", "repro_torch.fed.scenarios",
                 "repro_torch.fed.sampling", "repro_torch.fed.faults",
                 "repro_torch.fed.events",
                 "repro_torch.checkpoint.msgpack_ckpt",
                 "repro_torch.core.distributed", "repro_torch.configs",
                 "repro_torch.configs.registry",
                 "repro_torch.configs.smollm_135m",
                 "repro_torch.models.config", "repro_torch.models.flash",
                 "repro_torch.models.attention",
                 "repro_torch.models.transformer",
                 "repro_torch.launch.mesh", "repro_torch.launch.train",
                 "repro_torch.launch.serve", "repro_torch.models.moe",
                 "repro_torch.models.mla", "repro_torch.models.ssm",
                 "repro_torch.models.rglru", "repro_torch.optim",
                 "repro_torch.optim.sgd", "repro_torch.optim.schedules",
                 "repro_torch.sharding.rules", "repro_torch.launch.dryrun",
                 "repro_torch.launch.hardware", "repro_torch.kernels.ref"):
        assert name in mods


# Names of the reference's package surfaces that belong to the mesh path.
# Its ``core`` and ``fed`` ``__all__`` export none: the mesh path lives in
# modules they do not re-export.
MESH_PATH_NAMES = frozenset()

# What the port leaves of each newer surface: nothing now, but for
# ``kernels``' ``resolve_interpret``, which it leaves out on purpose (a
# wrapper picks its kernel or its plain version from the tensor's device).
NOT_YET = {
    "models": set(),
    "models.ssm": set(),
    "models.rglru": set(),
    "launch.train": set(),
    "launch.serve": set(),
    "launch.mesh": set(),
    "launch.dryrun": set(),
    "sharding.rules": set(),
    "kernels": {"resolve_interpret"},
    "configs": set(),
    "core.distributed": set(),
    "optim": set(),
    "models.moe": set(),
    "models.mla": set(),
}


# The reference's dry run has no ``__all__``: its surface is its entry
# points and the two measurements its records carry (its
# ``parse_collectives`` reads XLA's optimized HLO text, which PyTorch has
# no counterpart of).
REF_SURFACE = {"launch.dryrun": {"lower_combo", "save_record", "main",
                                 "measured_ingest_bytes",
                                 "fleet_event_stats"}}


@pytest.mark.parametrize("package", ["core", "fed"])
def test_public_surface_matches_reference(package):
    """``repro_torch.core`` / ``repro_torch.fed`` export every name of the
    reference's ``__all__`` but the mesh path's."""
    import importlib
    ref = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    missing = set(ref.__all__) - set(port.__all__) - MESH_PATH_NAMES
    assert not missing, sorted(missing)
    for name in port.__all__:
        assert hasattr(port, name), name


@pytest.mark.parametrize("module", sorted(NOT_YET))
def test_mesh_slice_surface_matches_reference(module):
    """The mesh slice's modules export every name of the reference's
    ``__all__`` but those named in ``NOT_YET``.  The reference's dry run
    sets ``XLA_FLAGS`` when imported: JAX's backend starts first, and the
    variable is put back."""
    import importlib
    import os
    import jax
    jax.devices()
    flags = os.environ.get("XLA_FLAGS")
    ref = importlib.import_module(f"repro.{module}")
    if flags is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = flags
    port = importlib.import_module(f"repro_torch.{module}")
    surface = REF_SURFACE.get(module) or set(ref.__all__)
    assert all(hasattr(ref, name) for name in surface)
    missing = surface - set(port.__all__) - NOT_YET[module]
    assert not missing, sorted(missing)
    assert not NOT_YET[module] & set(port.__all__)
    for name in port.__all__:
        assert hasattr(port, name), name


def test_quickstart_twin_runs_on_the_cpu_without_jax():
    code = _BLOCKER + f"""
import runpy
sys.argv = ["quickstart_torch.py", "--device", "cpu"]
runpy.run_path({str(ROOT / "examples" / "quickstart_torch.py")!r},
               run_name="__main__")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "roundtrip exact: True" in out.stdout
    assert "error feedback: msg + residual == update (exact)" in out.stdout


def test_train_lm_twin_runs_on_the_cpu_without_jax():
    code = _BLOCKER + f"""
import runpy
sys.argv = ["train_federated_lm_torch.py", "--device", "cpu", "--ranks",
            "1", "--steps", "2", "--seq", "32", "--batch", "4",
            "--eval-every", "1"]
runpy.run_path({str(ROOT / "examples" / "train_federated_lm_torch.py")!r},
               run_name="__main__")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("step ") == 2
    assert "nnz_up" in out.stdout and "final loss" in out.stdout


def test_serve_twin_runs_on_the_cpu_without_jax():
    code = _BLOCKER + f"""
import runpy
sys.argv = ["serve_decode_torch.py", "--device", "cpu", "--tokens", "4",
            "--prompt-len", "5"]
runpy.run_path({str(ROOT / "examples" / "serve_decode_torch.py")!r},
               run_name="__main__")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "arch=mamba2-370m-smoke  batch=2  generated 4 tokens/seq" in \
        out.stdout
    assert "tok/s" in out.stdout and "on CPU" in out.stdout


def test_moe_arch_runs_through_both_clis_on_the_cpu_without_jax():
    """``--arch deepseek-v2-lite-16b`` (MLA and MoE blocks) in the serve
    twin and in the mesh trainer's CLI."""
    code = _BLOCKER + f"""
import runpy
sys.argv = ["serve_decode_torch.py", "--device", "cpu", "--tokens", "3",
            "--prompt-len", "4", "--arch", "deepseek-v2-lite-16b"]
runpy.run_path({str(ROOT / "examples" / "serve_decode_torch.py")!r},
               run_name="__main__")
from repro_torch.launch.train import main
main(["--device", "cpu", "--steps", "2", "--arch", "deepseek-v2-lite-16b"])
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "arch=deepseek-v2-lite-16b-smoke  batch=2  generated 3" in \
        out.stdout
    assert out.stdout.count("step ") == 2 and "nnz_up" in out.stdout


def test_zoo_archs_run_through_both_twins_on_the_cpu_without_jax():
    """whisper (frames encoded into the decode's memory) through the serve
    twin, the hybrid through the train twin."""
    code = _BLOCKER + f"""
import runpy
sys.argv = ["serve_decode_torch.py", "--device", "cpu", "--tokens", "3",
            "--prompt-len", "4", "--arch", "whisper-medium"]
runpy.run_path({str(ROOT / "examples" / "serve_decode_torch.py")!r},
               run_name="__main__")
sys.argv = ["train_federated_lm_torch.py", "--device", "cpu", "--ranks",
            "1", "--steps", "2", "--seq", "32", "--batch", "4",
            "--eval-every", "1", "--arch", "recurrentgemma-2b"]
runpy.run_path({str(ROOT / "examples" / "train_federated_lm_torch.py")!r},
               run_name="__main__")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "encoded 30 audio frames" in out.stdout
    assert "arch=whisper-medium-smoke  batch=2  generated 3" in out.stdout
    assert "arch=recurrentgemma-2b-smoke" in out.stdout
    assert out.stdout.count("step ") == 2 and "final loss" in out.stdout


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
