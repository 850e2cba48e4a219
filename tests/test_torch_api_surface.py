"""The port's public surface covers the JAX package's.

A port copy of tests/test_migration_surface.py: every ``nsc.<module>.<name>``
that docs/migration.md names resolves against neural_spectral_codec_torch,
one case per symbol. Beyond the guide: every subpackage ``__init__`` and
the lazy top-level API export the JAX package's names, and every top-level
public name of every JAX module (found by walking its syntax tree, so no
JAX module is imported here) exists in the module of the same path in the
port. The exceptions are ROADMAP.md's "Not to port" list (TPU and JAX
workarounds) and the names a JAX module imports from jax, typing and the
standard library.
"""

import ast
import importlib
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

JAX_PKG = REPO / "neural_spectral_codec_tpu"
PORT = "neural_spectral_codec_torch"
GUIDE = REPO / "docs" / "migration.md"
PATTERN = re.compile(r"`nsc\.([A-Za-z0-9_.]+?)(\.\*)?`")

# ROADMAP.md "Not to port": whole modules, then single names
NOT_PORTED_MODULES = {"ops/pallas_compact.py", "ops/pallas_densify.py",
                      "ops/pallas_ring.py", "ops/pallas_spectral.py",
                      "utils/platform.py", "native/_build.py"}
NOT_PORTED = {"init_gnn", "ring_stage_bounds", "enable_compilation_cache",
              "load_library"}
# module-level helpers of the JAX files that are no API: its logger, the
# JAX package's native build directory, names its __init__s import from
# jax, typing and the standard library
IMPORTED = {"logger", "NATIVE_DIR", "annotations", "ctypes", "logging",
            "np", "Optional", "Tuple"}


def _guide_targets():
    seen = []
    for m in PATTERN.finditer(GUIDE.read_text()):
        t = (m.group(1), bool(m.group(2)))
        if t not in seen:
            seen.append(t)
    return sorted(seen)


TARGETS = _guide_targets()


def _resolve(dotted: str):
    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(f"{PORT}." + ".".join(parts[:i]))
        except ImportError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj
    raise AssertionError(f"cannot resolve nsc.{dotted}")


def test_guide_found_symbols():
    assert len(TARGETS) >= 40, "migration guide parse found too few symbols"


@pytest.mark.parametrize("dotted,wildcard", TARGETS,
                         ids=[t[0] for t in TARGETS])
def test_guide_symbol_exists_in_port(dotted, wildcard):
    if wildcard:
        importlib.import_module(f"{PORT}.{dotted}")
    else:
        _resolve(dotted)


def _public_names(path: Path):
    """Top-level public names a module defines, from its syntax tree; an
    ``__init__`` also counts the names it imports (its re-exports)."""
    reexports = path.name == "__init__.py"
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
        elif reexports and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return {n for n in names if not n.startswith("_")}


JAX_MODULES = sorted(
    str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py")
    if str(p.relative_to(JAX_PKG)) not in NOT_PORTED_MODULES)


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_name_of_jax_module_in_port(rel):
    want = _public_names(JAX_PKG / rel) - NOT_PORTED - IMPORTED
    parts = [p for p in rel[:-3].split("/") if p != "__init__"]
    port = importlib.import_module(".".join([PORT] + parts))
    missing = sorted(n for n in want if not hasattr(port, n))
    assert not missing, f"{rel}: {missing}"


LAZY = ["SpectralEncoderConfig", "encode_points_batch", "pad_points",
        "KeyframeSelector", "Keyframe", "TemporalGraphManager",
        "build_graph_from_keyframes", "SpectralGNN", "GNNTrainer",
        "TripletMiner", "WassersteinRetriever", "TwoStageRetrieval",
        "GeometricVerifier", "NeuralSpectralCodecPipeline", "run_pipeline",
        "run_benchmark", "load_config", "Profiler"]


@pytest.mark.parametrize("name", LAZY)
def test_lazy_top_level_name(name):
    """JAX ``__init__.py:31-59``'s 18 lazy names, each the object of the
    port's module of the same path (``run_benchmark`` is
    ``evaluation.run_benchmark``, as in JAX)."""
    import neural_spectral_codec_torch as nsc
    obj = getattr(nsc, name)
    assert obj is getattr(importlib.import_module(obj.__module__), name)
    assert obj.__module__.startswith(PORT + ".")


def test_lazy_api_is_jax_list_and_unknown_raises():
    import neural_spectral_codec_torch as nsc
    tree = ast.parse((JAX_PKG / "__init__.py").read_text())
    jax_names = {k.value for node in ast.walk(tree)
                 if isinstance(node, ast.Dict) for k in node.keys}
    assert jax_names == set(LAZY) == set(nsc._EXPORTS)
    assert nsc.ops.__name__ == PORT + ".ops"
    with pytest.raises(AttributeError):
        nsc.no_such_name


def test_quaternion_helpers_are_pose_utils_objects():
    """``ops.quantization`` carries JAX's four SE(3) ↔ 7-DoF helpers
    (JAX ops/quantization.py:101-155) as the same objects as
    ``data.pose_utils``."""
    from neural_spectral_codec_torch.data import pose_utils
    from neural_spectral_codec_torch.ops import quantization
    for name in ("matrix_to_quat_wxyz", "quat_wxyz_to_matrix",
                 "pose_to_7dof", "pose_from_7dof"):
        assert getattr(quantization, name) is getattr(pose_utils, name)


def test_import_is_cheap():
    """Importing the package and resolving every lazy name builds no
    kernel and loads no native library (a fresh interpreter)."""
    code = (
        "import sys\n"
        "import neural_spectral_codec_torch as p\n"
        "for n in p._EXPORTS: getattr(p, n)\n"
        "import neural_spectral_codec_torch.native, "
        "neural_spectral_codec_torch.ops\n"
        "from neural_spectral_codec_torch.native import _gxx\n"
        "loaded = [m for m in ('neural_spectral_codec_torch._build',) "
        "if m in sys.modules]\n"
        "assert not loaded, loaded\n"
        "from neural_spectral_codec_torch.native import geom, io\n"
        "assert geom._LIB._lib is None and io._LIB._lib is None\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
