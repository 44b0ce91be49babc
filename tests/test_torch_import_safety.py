"""The port stands alone: no module of jepsen_tpu_torch, and neither
chip_smoke.py, kernel_ab.py, the parity cases chip_smoke.py loads
and elle cases (tests/torch_parity_cases.py, tests/torch_elle_cases.py)
nor the card tests the card runs without JAX
(tests/test_torch_config_pack_kernels.py,
tests/test_torch_sparse_batch_cuda.py, tests/test_torch_stream_cuda.py,
tests/test_torch_serve_cuda.py, tests/test_torch_fleet_cuda.py,
tests/test_torch_mesh_cuda.py, tests/test_torch_elle_cuda.py,
tests/test_torch_obs_cuda.py),
imports JAX or anything of the JAX package (jepsen_tpu).
Checked twice: by importing everything in a fresh interpreter and
reading sys.modules, and by scanning the sources' import statements."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "jepsen_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "kernel_ab.py",
    ROOT / "tests" / "torch_parity_cases.py",
    ROOT / "tests" / "torch_elle_cases.py",
    ROOT / "tests" / "test_torch_config_pack_kernels.py",
    ROOT / "tests" / "test_torch_sparse_batch_cuda.py",
    ROOT / "tests" / "test_torch_stream_cuda.py",
    ROOT / "tests" / "test_torch_serve_cuda.py",
    ROOT / "tests" / "test_torch_fleet_cuda.py",
    ROOT / "tests" / "test_torch_mesh_cuda.py",
    ROOT / "tests" / "test_torch_elle_cuda.py",
    ROOT / "tests" / "test_torch_obs_cuda.py"]

_PROBE = r"""
import importlib, pkgutil, sys
import jepsen_tpu_torch
names = ["jepsen_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(jepsen_tpu_torch.__path__,
                                          "jepsen_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke  # imported, not run
import kernel_ab
sys.path.insert(0, "tests")
import test_torch_config_pack_kernels  # its cases are built, nothing runs
import test_torch_sparse_batch_cuda
import test_torch_stream_cuda
import test_torch_serve_cuda
import test_torch_fleet_cuda
import test_torch_mesh_cuda
import torch_elle_cases
import test_torch_elle_cuda
import test_torch_obs_cuda
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("jaxlib.")
             or m == "jepsen_tpu" or m.startswith("jepsen_tpu."))
print("MODULES", len(names))
print("SPARSE", sorted(n for n in names if "sparse" in n))
print("SHARDED", sorted(n for n in names if n.endswith(("sharded", "meshplan",
                                                        "elastic"))))
print("BATCH", sorted(n for n in names if n.endswith(("independent", "encode",
                                                      "closure_kernels"))))
print("STREAM", sorted(n for n in names if n.endswith(("extend",
                                                       "pipeline"))))
print("SERVE", sorted(n for n in names if ".serve" in n
                      or n.endswith("envflags")))
print("OPS", sorted(n for n in names if ".obs" in n or ".resilience" in n))
print("ELLE", sorted(n for n in names if ".elle" in n
                     or ".workloads" in n or n.endswith(("probe", ".core"))))
print("BAD", bad)
"""


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "jepsen_tpu")


def test_port_and_smoke_import_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode == 0, proc.stderr
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines())
    assert int(lines["MODULES"]) >= 36, proc.stdout
    assert lines["STREAM"] == str(["jepsen_tpu_torch.parallel.extend",
                                   "jepsen_tpu_torch.parallel.pipeline"]), \
        proc.stdout
    assert lines["SERVE"] == str(sorted(
        ["jepsen_tpu_torch.envflags", "jepsen_tpu_torch.serve"]
        + [f"jepsen_tpu_torch.serve.{m}" for m in (
            "__main__", "fleet", "ingress", "ring", "service", "stdio",
            "tenancy", "wal")])), proc.stdout
    assert lines["OPS"] == str(sorted(
        [f"jepsen_tpu_torch.{m}" for m in (
            "obs", "obs.capture", "obs.export", "obs.httpd", "obs.metrics",
            "obs.tracer",
            "resilience", "resilience.breaker")])), proc.stdout
    assert lines["SPARSE"] == str(["jepsen_tpu_torch.parallel.sparse",
                                   "jepsen_tpu_torch.parallel."
                                   "sparse_kernels"]), proc.stdout
    assert lines["SHARDED"] == str(["jepsen_tpu_torch.parallel.elastic",
                                    "jepsen_tpu_torch.parallel.meshplan",
                                    "jepsen_tpu_torch.parallel.sharded"]), \
        proc.stdout
    assert lines["BATCH"] == str(["jepsen_tpu_torch.independent",
                                  "jepsen_tpu_torch.parallel.closure_kernels",
                                  "jepsen_tpu_torch.parallel.encode"]), \
        proc.stdout
    assert lines["ELLE"] == str(sorted(
        [f"jepsen_tpu_torch.{m}" for m in (
            "checker.core", "elle", "elle.list_append", "elle.rw_register",
            "elle.txn", "probe", "workloads", "workloads.cycle")])), \
        proc.stdout
    assert lines["BAD"] == "[]", proc.stdout


OBS_MODULES = ("obs", "obs.tracer", "obs.export", "obs.metrics",
               "obs.httpd", "obs.capture")


@pytest.mark.parametrize("module", OBS_MODULES)
def test_obs_module_imports_no_torch(module):
    """The telemetry modules load no torch (the profiler bridge imports
    it inside its factories): the probe's parent and the ops server
    keep working while a card is wedged. The disabled tracer's calls
    and the bridge's no-op path load none either."""
    code = ("import sys\n"
            f"import jepsen_tpu_torch.{module}\n"
            "from jepsen_tpu_torch import obs\n"
            "with obs.span('x'), obs.maybe_torch_profile(), "
            "obs.device_annotation('y'):\n"
            "    obs.counter('c').inc()\n"
            "print(sorted(m for m in sys.modules if m == 'torch'"
            " or m.startswith('torch.') or m.split('.')[0] in "
            "('jax', 'jaxlib', 'jepsen_tpu')))\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("JEPSEN_TPU_TORCH_")}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_probe_parent_imports_no_torch():
    """The probe's parent never initialises CUDA: importing it (and the
    watch's gauges) pulls in no torch."""
    code = ("import sys\n"
            "from jepsen_tpu_torch import probe\n"
            "probe.ProbeWatch._gauges()\n"
            "print(sorted(m for m in sys.modules if m == 'torch'"
            " or m.startswith('torch.')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_or_reference_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) in (
                "__import__", "import_module"):
            for a in node.args:
                if isinstance(a, ast.Constant) and isinstance(a.value, str) \
                        and _forbidden(a.value):
                    bad.append(a.value)
    assert not bad, f"{path.name} imports {bad}"


def test_prefix_check_tells_port_from_reference():
    assert _forbidden("jepsen_tpu.parallel.engine")
    assert _forbidden("jax.numpy")
    assert not _forbidden("jepsen_tpu_torch.parallel.engine")
