"""The port's call signatures and package surface against the JAX
package's.

For every module of ``pyqsm_tpu/`` with a counterpart at the same path in
``pyqsm_tpu_torch/``, every public function and method (and ``__init__``)
must exist in the port, and the port's positional parameters must begin
with the JAX package's, the same names in the same order: a call written
for the JAX package binds each argument to the same parameter in the port.
The port's own parameters (``device``, a backend, the collectives' ``mesh``)
come after them. The exceptions are listed below, each with its reason.
Every package ``__init__`` binds the JAX package's names, and importing the
port's packages builds no kernel, touches no card and imports no JAX.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "pyqsm_tpu"
PORT_PKG = ROOT / "pyqsm_tpu_torch"

# modules of the JAX package without a counterpart at the same path
NO_COUNTERPART = {
    # the three Pallas kernels live in ops/band_matvec.py (band_matvec_pallas,
    # band_matvec_t_pallas) and ops/mt_raycast.py (mt_raycast), beside the
    # wrappers that launch their CUDA kernels
    "ops/pallas_kernels.py",
}
# public functions without a counterpart in the module at the same path
NOT_PORTED = {
    # lives beside the kernel it serves, ops/mt_raycast.py; ops/raytrace
    # imports it from there
    ("ops/raytrace.py", "mt_components"),
    # turns on XLA's compilation cache; the port has no XLA, and its
    # kernels' builds are cached in _build/ (ops/cuda_build.py)
    ("pipeline/cli.py", "enable_compilation_cache"),
}
# parameters the port names otherwise on purpose: the JAX package's PRNG
# ``key`` is a CPU ``torch.Generator`` in the port, whose draws the tests
# replay from the JAX package's keys
RENAMED = {
    ("ops/ransac.py", "ransac_circle_2d"): {"key": "generator"},
    ("ops/ransac.py", "fit_cylinder"): {"key": "generator"},
    ("ops/ransac.py", "sample_cylinder_surface"): {"key": "generator"},
    ("ops/cluster.py", "kmeans"): {"key": "generator"},
    ("ops/cluster.py", "kmeans_sweep"): {"key": "generator"},
}


def _public_defs(path: Path) -> dict:
    """Top-level public functions and the public methods (and
    ``__init__``) of top-level public classes, by qualified name."""
    out = {}
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                out[node.name] = node
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
                        not sub.name.startswith("_") or sub.name == "__init__"):
                    out[f"{node.name}.{sub.name}"] = sub
    return out


def _positional(fn: ast.FunctionDef) -> list[str]:
    return [a.arg for a in fn.args.posonlyargs + fn.args.args]


MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py")
                 if p.name != "__init__.py")


def test_module_list_is_complete():
    """Every module of the JAX package but the listed one has a
    counterpart at the same path, and the listed one has none."""
    missing = {m for m in MODULES if not (PORT_PKG / m).exists()}
    assert missing == NO_COUNTERPART


@pytest.mark.parametrize("module", [m for m in MODULES if m not in NO_COUNTERPART])
def test_positional_parameters_begin_with_the_jax_packages(module):
    jax_defs = _public_defs(JAX_PKG / module)
    port_defs = _public_defs(PORT_PKG / module)
    bad = []
    for name, fn in jax_defs.items():
        if (module, name) in NOT_PORTED:
            assert name not in port_defs, f"{name} is ported now: drop it from NOT_PORTED"
            continue
        if name not in port_defs:
            bad.append(f"{name}: no counterpart")
            continue
        renamed = RENAMED.get((module, name), {})
        want = [renamed.get(a, a) for a in _positional(fn)]
        got = _positional(port_defs[name])
        if got[:len(want)] != want:
            bad.append(f"{name}: JAX package {want}, port {got}")
        for old, new in renamed.items():
            assert old in _positional(fn) and new in got, f"stale rename in {name}: {old}"
    assert not bad, "\n".join(bad)


def test_collectives_take_mesh_by_keyword_only():
    """The sharded step's collectives take the JAX package's parameters,
    ``axis`` included, and the port's ``mesh`` after them as a keyword:
    ``sharded_cg``'s ``iters`` has a default, so ``mesh`` cannot follow
    it positionally."""
    defs = _public_defs(PORT_PKG / "parallel/collective_ops.py")
    for name in ("ring_knn", "sharded_laplacian_matvec", "sharded_laplacian_rmatvec",
                 "sharded_cg", "psum_inlier_count", "label_prop_round"):
        fn = defs[name]
        assert [a.arg for a in fn.args.kwonlyargs] == ["mesh"], name
        assert "axis" in _positional(fn), name


def _init_bindings(path: Path) -> tuple[set[str], list[str] | None, dict]:
    """Names an ``__init__.py`` imports, its ``__all__`` and its constant
    assignments."""
    names, all_, consts = set(), None, {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(
                node.targets[0], ast.Name):
            target = node.targets[0].id
            value = ast.literal_eval(node.value)
            if target == "__all__":
                all_ = list(value)
            else:
                consts[target] = value
    return names, all_, consts


INITS = sorted(str(p.relative_to(JAX_PKG).parent) for p in JAX_PKG.rglob("__init__.py"))


@pytest.mark.parametrize("package", INITS)
def test_package_binds_the_jax_packages_names(package):
    """Each package of the port binds every name the JAX package's
    ``__init__`` binds (``ops``' four submodules, ``__version__``), lists
    the JAX package's ``__all__`` in its own, and holds the same
    constants."""
    import importlib

    names, all_, consts = _init_bindings(JAX_PKG / package / "__init__.py")
    mod_name = "pyqsm_tpu_torch" + ("" if package == "." else "." + package.replace("/", "."))
    port = importlib.import_module(mod_name)
    missing = sorted(n for n in names | set(consts) | set(all_ or []) if not hasattr(port, n))
    assert not missing, f"{mod_name} lacks {missing}"
    if all_ is not None:
        assert not set(all_) - set(port.__all__), f"{mod_name}.__all__"
    for k, v in consts.items():
        assert getattr(port, k) == v, k


def test_importing_the_packages_builds_nothing():
    """Importing every package of the port (``ops`` with its four
    submodules) starts no process, loads no kernel library, initialises no
    card and imports no JAX."""
    code = (
        "import subprocess, sys\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError(f'a process was started: {a}')\n"
        "subprocess.Popen = refuse\n"
        "import torch\n"
        "import pyqsm_tpu_torch, pyqsm_tpu_torch.ops, pyqsm_tpu_torch.io\n"
        "import pyqsm_tpu_torch.models, pyqsm_tpu_torch.parallel, pyqsm_tpu_torch.pipeline\n"
        "import pyqsm_tpu_torch.utils\n"
        "from pyqsm_tpu_torch.ops import band_matvec, cuda_build, mt_raycast\n"
        "assert cuda_build.REGISTRY and all(lib._lib is None for lib in cuda_build.REGISTRY)\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert not {m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'pyqsm_tpu'}\n"
        "ops = pyqsm_tpu_torch.ops\n"
        "assert all(hasattr(ops, n) for n in ('neighbors', 'sampling', 'outliers', 'normals'))\n"
        "assert pyqsm_tpu_torch.__version__ == '0.1.0'\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=180)
    assert out.returncode == 0, out.stderr
