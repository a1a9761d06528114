"""The port covers the JAX package, read from source.

For every ``.py`` under ``optpricer_tpu/`` and every script under
``scripts/``, each public module-level ``def`` and ``class`` has a
counterpart in ``optpricer_tpu_torch/``: the same name defined in the port
module at the same relative path (a kernel module ``ops/pallas_<x>.py``
maps to its wrapper module, ``WRAPPERS``; a script to
``optpricer_tpu_torch/scripts/``), an entry of ``RENAMED``, or an entry of
``LEFT_BEHIND`` with its reason. The scan parses both trees with ``ast``
and imports neither package; ``RENAMED`` targets must be defined in the
port and ``LEFT_BEHIND`` keys must still be in the reference, so neither
map goes stale.

The port's own invariants are read the same way: no file of the port and
no line of ``chip_smoke.py`` imports ``jax`` or ``optpricer_tpu``, and no
``except`` clause in the port catches the errors a kernel's build or launch
raises. Every public entry point takes ``device=None``, which
``dtypes.resolve_device`` reads as ``"cuda"``: on a host without a card
the call raises unless it asks for the CPU.
"""
import argparse
import ast
import inspect
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
REF = "optpricer_tpu"
PORT = "optpricer_tpu_torch"

# ops/pallas_<x>.py -> the port's wrapper module of the same kernel
WRAPPERS = {"pallas_mc": "terminal_mc", "pallas_mc_batch": "mc_batch",
            "pallas_path_mc": "path_mc", "pallas_qmc_path": "qmc_path",
            "pallas_basket_mc": "basket_mc", "pallas_tridiag": "thomas",
            "pallas_fd_lv": "fd_lv"}

# "reference file:name" -> "port file:name" (the kernel entries' *_pallas
# became *_kernel; the bridge matrix lives with the Sobol tables)
RENAMED = {
    f"{REF}/ops/pallas_mc.py:mc_sumstats_pallas":
        f"{PORT}/ops/terminal_mc.py:mc_sumstats_kernel",
    f"{REF}/ops/pallas_mc.py:mc_sumstats_pallas_sharded":
        f"{PORT}/ops/terminal_mc.py:mc_sumstats_kernel_sharded",
    f"{REF}/ops/pallas_mc.py:pallas_estimate":
        f"{PORT}/ops/terminal_mc.py:terminal_estimate",
    f"{REF}/ops/pallas_mc.py:pallas_greeks":
        f"{PORT}/ops/terminal_mc.py:terminal_greeks",
    f"{REF}/ops/pallas_path_mc.py:path_mc_sumstats_pallas":
        f"{PORT}/ops/path_mc.py:path_mc_sumstats_kernel",
    f"{REF}/ops/pallas_path_mc.py:path_mc_sumstats_pallas_sharded":
        f"{PORT}/ops/path_mc.py:path_mc_sumstats_kernel_sharded",
    f"{REF}/ops/pallas_qmc_path.py:path_qmc_sumstats_pallas":
        f"{PORT}/ops/qmc_path.py:path_qmc_sumstats_kernel",
    f"{REF}/ops/pallas_qmc_path.py:bridge_matrix":
        f"{PORT}/ops/sobol.py:bridge_matrix",
    f"{REF}/ops/pallas_basket_mc.py:basket_path_sumstats_pallas":
        f"{PORT}/ops/basket_mc.py:basket_path_sumstats_kernel",
    f"{REF}/ops/pallas_basket_mc.py:basket_path_sumstats_pallas_sharded":
        f"{PORT}/ops/basket_mc.py:basket_path_sumstats_kernel_sharded",
    f"{REF}/ops/pallas_tridiag.py:tridiag_solve_pallas":
        f"{PORT}/ops/thomas.py:tridiag_solve_kernel",
    f"{REF}/ops/pallas_tridiag.py:tridiag_solve_pallas_lastdim":
        f"{PORT}/ops/thomas.py:tridiag_solve_kernel_lastdim",
    f"{REF}/ops/pallas_fd_lv.py:fd_lv_ladder_pallas":
        f"{PORT}/ops/fd_lv.py:fd_lv_ladder_kernel",
}

# "reference file:name", or a whole file -> why the port has no counterpart
_BITCAST = ("TPU-only, ROADMAP 'Leave behind': \"the Mosaic-interpreter "
            "PRNG stub handling and the i64→i32 casts "
            "(pallas_mc.py:73-83)\"; the CUDA kernels read the Threefry "
            "words as uint32")
LEFT_BEHIND = {
    f"{REF}/ops/pallas_mc.py:pltpu_bitcast_i32_to_u32": _BITCAST,
    f"{REF}/ops/pallas_mc.py:pltpu_bitcast_u32_to_i32": _BITCAST,
    "scripts/make_notebooks.py": (
        "repo tooling: writes notebooks/ from examples/, which drive the "
        "JAX package and are not part of it"),
}

REF_MODULES = sorted(
    p.relative_to(REPO).as_posix()
    for p in [*(REPO / REF).rglob("*.py"), *(REPO / "scripts").glob("*.py")])


def _tree(rel: str) -> ast.Module:
    return ast.parse((REPO / rel).read_text(encoding="utf-8"), filename=rel)


def _top_level(body):
    """The statements of a module body, with those inside top-level ``if``
    and ``try`` blocks."""
    for node in body:
        yield node
        if isinstance(node, ast.If):
            yield from _top_level(node.body + node.orelse)
        elif isinstance(node, ast.Try):
            yield from _top_level(node.body + node.orelse + node.finalbody
                                  + [s for h in node.handlers for s in h.body])


def _public(rel: str) -> list:
    """The public module-level functions and classes of ``rel``."""
    return [node.name for node in _tree(rel).body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef))
            and not node.name.startswith("_")]


def _defined(rel: str) -> set:
    """Every name ``rel`` defines at module level (functions, classes and
    assignments; imports do not count)."""
    names = set()
    for node in _top_level(_tree(rel).body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            names.update(t.id for t in targets if isinstance(t, ast.Name))
    return names


def counterpart(rel: str) -> str:
    """The port module that answers reference module ``rel``."""
    path = Path(rel)
    if path.parts[0] == "scripts":
        return f"{PORT}/scripts/{path.name}"
    inner = path.relative_to(REF)
    if inner.parent.as_posix() == "ops" and inner.stem in WRAPPERS:
        inner = inner.with_name(WRAPPERS[inner.stem] + ".py")
    return f"{PORT}/{inner.as_posix()}"


@pytest.mark.parametrize("rel", REF_MODULES)
def test_module_has_its_counterpart_in_the_port(rel):
    if rel in LEFT_BEHIND:
        return
    target = counterpart(rel)
    assert (REPO / target).is_file(), f"{rel}: no {target}"
    here = _defined(target)
    missing = [name for name in _public(rel)
               if f"{rel}:{name}" not in LEFT_BEHIND
               and f"{rel}:{name}" not in RENAMED and name not in here]
    assert not missing, f"{rel}: no counterpart in {target} for {missing}"


@pytest.mark.parametrize("key", sorted(RENAMED))
def test_renamed_entry_is_live(key):
    """The reference still defines the name, the port defines its target,
    and the same name in the counterpart module would not already do."""
    rel, _, name = key.partition(":")
    assert name in _public(rel), f"{key}: gone from the reference"
    target_rel, _, target = RENAMED[key].partition(":")
    assert target in _defined(target_rel), f"{RENAMED[key]}: not in the port"
    assert name not in _defined(counterpart(rel)), \
        f"{key}: the port defines the same name in {counterpart(rel)}"


@pytest.mark.parametrize("key", sorted(LEFT_BEHIND))
def test_left_behind_entry_is_live(key):
    """A reason, and the name or file is still in the reference."""
    assert len(LEFT_BEHIND[key]) > 40, key
    rel, _, name = key.partition(":")
    assert (REPO / rel).is_file() and (not name or name in _public(rel)), \
        f"{key}: gone from the reference; drop the entry"


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_and_smoke_import_neither_jax_nor_the_reference():
    files = sorted(p.relative_to(REPO).as_posix()
                   for p in (REPO / PORT).rglob("*.py")) + ["chip_smoke.py"]
    bad = [(rel, module) for rel in files for module in _imports(_tree(rel))
           if module.split(".")[0] in ("jax", "jaxlib", REF)]
    assert not bad, bad


# the errors a failed build or launch raises: a wrapper that caught them
# could answer with its plain version
_BUILD_OR_LAUNCH = {"Exception", "BaseException", "RuntimeError", "OSError",
                    "SubprocessError", "CalledProcessError", "TimeoutExpired",
                    "AcceleratorError", "CudaError"}


def _handler_names(node, aliases):
    """The exception class names an ``except`` clause names, tuples and
    module-level tuple aliases expanded; ``None`` for a bare ``except``."""
    if node is None:
        return {None}
    if isinstance(node, ast.Tuple):
        return set().union(*(_handler_names(e, aliases) for e in node.elts))
    if isinstance(node, ast.Name) and node.id in aliases:
        return _handler_names(aliases[node.id], aliases)
    if isinstance(node, ast.Name):
        return {node.id}
    if isinstance(node, ast.Attribute):
        return {node.attr}
    return {ast.unparse(node)}


def test_no_except_clause_catches_a_build_or_launch_error():
    caught = []
    for path in sorted((REPO / PORT).rglob("*.py")):
        rel = path.relative_to(REPO).as_posix()
        tree = _tree(rel)
        aliases = {t.id: node.value for node in tree.body
                   if isinstance(node, ast.Assign)
                   and isinstance(node.value, ast.Tuple)
                   for t in node.targets if isinstance(t, ast.Name)}
        for node in ast.walk(tree):
            if isinstance(node, ast.ExceptHandler):
                names = _handler_names(node.type, aliases)
                if None in names or names & _BUILD_OR_LAUNCH:
                    caught.append((rel, node.lineno, names))
    assert not caught, caught


def test_entry_points_default_to_the_card():
    import optpricer_tpu_torch as tp
    from optpricer_tpu_torch import cli, dtypes
    from optpricer_tpu_torch.scripts import calibrate_surface, price_book
    from optpricer_tpu_torch.scripts import desk_workflow_localvol_barrier

    assert dtypes.DEFAULT_DEVICE == "cuda"
    with_device = 0
    for name in tp.__all__:
        obj = getattr(tp, name)
        try:
            param = inspect.signature(obj).parameters.get("device")
        except (TypeError, ValueError):
            continue
        if param is not None:
            with_device += 1
            assert param.default is None, name
    assert with_device >= 90
    parsers = [cli.build_parser()]
    parsers += [action.choices[c] for action in parsers[0]._actions
                if isinstance(action, argparse._SubParsersAction)
                for c in action.choices]
    defaults = [a.default for p in parsers for a in p._actions
                if "--device" in a.option_strings]
    assert len(defaults) == len(parsers) - 1 and set(defaults) == {"cuda"}
    for script in (calibrate_surface, price_book,
                   desk_workflow_localvol_barrier):
        source = inspect.getsource(script.main)
        assert ('"--device", default="cuda"' in source
                or '"--device", default=None' in source), script.__name__


ENTRY_CALLS = {
    "bs_price": lambda tp, spec: tp.bs_price(spec, "call"),
    "crr": lambda tp, spec: tp.crr(spec, "put", N=8, american=True),
    "fd_price": lambda tp, spec: tp.fd_price(spec, "call", N_S=16, N_t=8),
    "exotic_price_mc": lambda tp, spec: tp.exotic_price_mc(
        "asian", 100.0, 100.0, 1.0, 0.03, sigma=0.2, n_steps=4, n_paths=64),
    "heston_price_cos": lambda tp, spec: tp.heston_price_cos(
        100.0, 100.0, 1.0, 0.03, v0=0.04, kappa=1.5, theta=0.04, xi=0.5,
        rho=-0.6),
    "lsmc_price": lambda tp, spec: tp.lsmc_price(spec, "put", n_paths=64,
                                                 n_steps=4),
}


@pytest.mark.parametrize("name", sorted(ENTRY_CALLS))
def test_entry_point_refuses_the_cpu_by_default(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    import optpricer_tpu_torch as tp

    spec = tp.OptionSpec(S0=100.0, K=100.0, T=1.0, r=0.03, sigma=0.2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_CALLS[name](tp, spec)
