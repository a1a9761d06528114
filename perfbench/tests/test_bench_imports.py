"""Nothing the benchmark loads brings in JAX or the JAX package, and the
references import nothing of the program."""
import ast
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optpricer_tpu")

SCRIPT = """
import importlib, json, pkgutil, sys
sys.path.insert(0, {root!r})
import perfbench.harness, perfbench.generator, perfbench.trace
for pkg in ("entries", "reference", "metrics", "counts"):
    mod = importlib.import_module("perfbench." + pkg)
    for info in pkgutil.iter_modules(mod.__path__):
        importlib.import_module(f"perfbench.{{pkg}}.{{info.name}}")
port = sorted(m for m in sys.modules
              if m.split(".")[0] == "optpricer_tpu_torch")
{extra}
print(json.dumps({{"modules": sorted(sys.modules), "port": port}}))
"""


def _loaded(extra: str = "") -> dict:
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(root=str(ROOT), extra=extra)],
        capture_output=True, text=True, check=True, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    return json.loads(out.stdout.strip().splitlines()[-1])


def _forbidden(modules) -> list:
    # whole top-level names: optpricer_tpu_torch is not optpricer_tpu
    return [m for m in modules if m.split(".", 1)[0] in FORBIDDEN]


def test_the_harness_loads_no_jax():
    got = _loaded()
    assert _forbidden(got["modules"]) == []
    # the harness, mixes, metrics, counts and references load no program
    assert got["port"] == []


def test_the_port_loads_no_jax():
    got = _loaded("import optpricer_tpu_torch, optpricer_tpu_torch.models."
                  "mc_fused, optpricer_tpu_torch.models.pde, "
                  "optpricer_tpu_torch.ops.mc_batch")
    assert "optpricer_tpu_torch" in got["modules"]
    assert _forbidden(got["modules"]) == []


def test_the_comparison_is_by_whole_names():
    assert _forbidden(["optpricer_tpu_torch.ops", "jaxtyping",
                       "numpy"]) == []
    assert _forbidden(["optpricer_tpu.ops", "jax.numpy"]) == [
        "optpricer_tpu.ops", "jax.numpy"]


def test_references_import_nothing_of_the_program():
    for path in sorted((HERE / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module] if node.level == 0 else []
            for name in names:
                top = name.split(".", 1)[0]
                assert top not in FORBIDDEN + ("optpricer_tpu_torch",
                                               "perfbench"), (path, name)


def test_run_guard_names_the_same_modules():
    sys.path.insert(0, str(HERE))
    try:
        import run
    finally:
        sys.path.remove(str(HERE))
    assert tuple(run.FORBIDDEN) == FORBIDDEN
    sys.modules["jaxlib.xla_client"] = sys.modules["json"]
    try:
        assert "jaxlib.xla_client" in run.loaded_forbidden()
    finally:
        del sys.modules["jaxlib.xla_client"]
    assert json.loads((ROOT / "BENCHMARK.json").read_text())["command"] == [
        "python3", "perfbench/run.py"]
