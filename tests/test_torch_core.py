"""The port's FOS policy core against the reference's.

Three holds on `repro_torch.core`, `repro_torch.analysis` (the sanitizer
and schedlint) and the copied training modules (`data/pipeline.py`,
`ckpt/fault.py`):

1. The copy check: every copied module's AST, docstrings removed, equals
   the reference module's after the package rename `repro.` ->
   `repro_torch.` (the daemon without its `import jax`).
2. The seven golden simulator traces (`tests/fixtures/sim_golden_*.json`)
   reproduce byte for byte through the port: `tests/golden_traces.py` is
   loaded with the same rename into a fresh module.
3. The reference's property suites run against the port by the same
   load-and-rename: each suite's tests are collected here as
   `test_<suite>__<test>` (of `test_fault_and_bus` only the fault tests).
   `Shell` is bound to a subclass on CPU devices
   (the port's `Shell` raises without CUDA), also for a suite that imports
   it inside a test.

The flight recorder (`repro_torch.obs`) is a copy too.  `test_obs`,
`test_network` and `test_simulator_core` import the golden builders by
the bare name `golden_traces`; while such a suite loads, and while each of
its tests runs, that name resolves to the port's copy of the module.
"""
from __future__ import annotations

import ast
import functools
import json
import sys
import types
from pathlib import Path

import pytest

from torch_cpu import torch  # noqa: E402

import repro_torch.core as port_core  # noqa: E402
from repro_torch.core.shell import Shell  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TESTS = ROOT / "tests"
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

# copied modules, by path under the package root
COPIED = ["core/allocator.py", "core/arrivals.py", "core/checkpoint.py",
          "core/network.py", "core/registry.py", "core/slo.py",
          "core/scheduler.py", "core/fabric.py", "core/simulator.py",
          "core/daemon.py", "core/__init__.py", "analysis/sanitizer.py",
          "obs/__init__.py", "obs/trace.py", "obs/recorder.py",
          "obs/export.py", "data/pipeline.py", "ckpt/fault.py",
          "analysis/walker.py", "analysis/config.py",
          "analysis/determinism.py", "analysis/memo.py",
          "analysis/mutation.py", "analysis/__main__.py",
          "analysis/__init__.py"]
SUITES = ["test_core_allocator", "test_core_scheduler", "test_fabric",
          "test_checkpoint", "test_preemption", "test_reservation",
          "test_slo", "test_obs", "test_network", "test_simulator_core",
          "test_analysis"]
# suites of which only some tests run unchanged on the port: the fault
# tests of test_fault_and_bus (its adaptor tests hold the reference's jax
# bus; tests/test_torch_daemon.py holds the port's)
PARTIAL_SUITES = {"test_fault_and_bus": (
    "test_watchdog_fires_on_stall", "test_watchdog_heartbeat_keeps_alive",
    "test_fault_injector_fires_once", "test_run_with_restarts_straggler_path",
    "test_run_with_restarts_gives_up")}
GOLDEN_MODULE = "_port_golden_traces"


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread while this file runs: the daemon runs chunks in
    up to 8 worker threads, and a team of intra-op threads for each of
    them oversubscribes the CPU when test files run in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def renamed(source: str) -> str:
    """The reference's source with its package renamed to the port's, and
    the golden-trace module pointed at the port's copy of it."""
    return (source.replace("repro.", "repro_torch.")
            .replace("tests.golden_traces", GOLDEN_MODULE))


class _Docstrings(ast.NodeTransformer):
    """Drops every module, class and function docstring."""

    def _strip(self, node):
        self.generic_visit(node)
        body = node.body
        if body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
        return node

    visit_Module = visit_ClassDef = _strip
    visit_FunctionDef = visit_AsyncFunctionDef = _strip


def _tree(source: str, drop_jax: bool = False) -> str:
    tree = _Docstrings().visit(ast.parse(source))
    if drop_jax:
        tree.body = [n for n in tree.body
                     if not (isinstance(n, ast.Import)
                             and [a.name for a in n.names] == ["jax"])]
    return ast.dump(tree)


# modules of which some top-level definitions are copied, by name
COPIED_DEFS = {"sharding/partition.py": (
    "MeshAxes", "AxisRules", "flat_axes", "make_rules", "_ACTIVE",
    "use_rules", "active_rules"),
    "launch/roofline_model.py": (
    "RooflineTerms", "model_flops", "scores_traffic_bytes"),
    "launch/dryrun.py": (
    "FULL_ATTENTION_SKIP", "cell_applicable", "scale_groups")}


def _defs(source: str) -> dict:
    """Each top-level def, class and assignment's AST, docstrings removed,
    by name."""
    out = {}
    for node in _Docstrings().visit(ast.parse(source)).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.dump(node)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                out[getattr(t, "id", "")] = ast.dump(node)
    return out


@pytest.mark.parametrize("path,name", [
    (p, n) for p, names in COPIED_DEFS.items() for n in names])
def test_copied_definition_matches_reference(path, name):
    """The copied definitions of a module the port otherwise rewrites."""
    want = _defs(renamed((REF / path).read_text()))
    got = _defs((PORT / path).read_text())
    assert name in got and got[name] == want[name], \
        f"{name} in src/repro_torch/{path} is no longer the reference's"


@pytest.mark.parametrize("path", COPIED)
def test_copied_module_matches_reference(path):
    """Comments and docstrings may be reworded; the code may not."""
    ref = renamed((REF / path).read_text())
    drop_jax = path == "core/daemon.py"
    assert _tree((PORT / path).read_text()) == _tree(ref, drop_jax), \
        f"src/repro_torch/{path} is no longer a copy of src/repro/{path}"


def test_copy_check_sees_a_changed_line():
    """The check fails on a code change and passes over a docstring."""
    ref = renamed((REF / "core/allocator.py").read_text())
    assert _tree(ref.replace('"""', '"""reworded ', 1)) == _tree(ref)
    changed = ref.replace("return", "return  0 or", 1)
    assert _tree(changed) != _tree(ref)


def _load(name: str, path: Path) -> types.ModuleType:
    """`path`'s source, renamed to the port, as a fresh module `name`."""
    mod = types.ModuleType(name)
    mod.__file__ = str(path)
    sys.modules[name] = mod
    exec(compile(renamed(path.read_text()), str(path), "exec"),
         mod.__dict__)
    return mod


@functools.cache
def golden() -> types.ModuleType:
    return _load(GOLDEN_MODULE, TESTS / "golden_traces.py")


def test_golden_module_runs_on_the_port():
    mod = golden()
    assert mod.simulate.__module__ == "repro_torch.core.simulator"
    assert len(mod.TRACES) == 7


@pytest.mark.parametrize("name", [
    "ckpt_incapable_mix", "congested_two_switch", "contracts_full",
    "hetero_steal_ckpt", "refine_hetero", "single_shell_seed",
    "static_reserve_preempt"])
def test_golden_trace_byte_identity(name):
    """The port's simulator reproduces the committed fixture byte for byte:
    the dump, written as the fixtures were written, equals the file."""
    mod = golden()
    got = mod.to_jsonable(mod.run_trace(name))
    assert got == mod.load_fixture(name)
    text = json.dumps(got, sort_keys=True, indent=1) + "\n"
    assert text == (TESTS / "fixtures" / f"sim_golden_{name}.json"
                    ).read_text()


# -- the reference's property suites against the port ---------------------


class CpuShell(Shell):
    """The port's Shell on CPU devices, whatever devices the caller names
    (a suite may pass jax's)."""

    def __init__(self, spec, devices=None):
        super().__init__(spec, [torch.device("cpu")]
                         * (spec.grid[0] * spec.grid[1]))


def _on_cpu(fn):
    """Run a suite's test with `Shell` bound to CpuShell and the name
    `golden_traces` to the port's copy, also for an import of either
    inside the test."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(port_core, "Shell", CpuShell)
            mp.setitem(sys.modules, "golden_traces", golden())
            return fn(*args, **kwargs)
    return run


def _collect(suite: str, only=None) -> None:
    with pytest.MonkeyPatch.context() as mp:
        # the suite's `from golden_traces import ...` binds the port's copy
        mp.setitem(sys.modules, "golden_traces", golden())
        mod = _load(f"_port_{suite}", TESTS / f"{suite}.py")
    if "Shell" in mod.__dict__:
        mod.Shell = CpuShell
    for name, obj in list(vars(mod).items()):
        if name.startswith("test_") and callable(obj) \
                and (only is None or name in only):
            alias = f"test_{suite.removeprefix('test_')}__" \
                    f"{name.removeprefix('test_')}"
            globals()[alias] = _on_cpu(obj)


for _suite in SUITES:
    _collect(_suite)
for _suite, _only in PARTIAL_SUITES.items():
    _collect(_suite, _only)
