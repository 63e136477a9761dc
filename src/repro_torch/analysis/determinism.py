"""Checker 3: determinism lint for simulator-path modules.

Golden-trace byte-identity and the incremental/full equivalence
properties assume the scheduling core is a pure function of its event
stream.  Five things silently break that:

  - **wall-clock** — `time.*` mixed into virtual time;
  - **randomness** — `random` / `jax.random` / `numpy.random` in a
    decision path;
  - **id-order** — `id()` used in ordering or keys (address-dependent);
  - **environ** — `os.environ` / `os.getenv` reads steering behavior;
  - **set-iter** — iterating (or `sum`ming, `list`ing, `pop`ping) an
    unordered set where order can reach a decision.  Membership tests,
    `sorted()`, `len()`, `min`/`max`/`any`/`all` are fine.

Sim-path modules (`config.SIM_MODULES` or an in-file
`SCHEDLINT_SIM = True`) get no module-level exceptions: an intentional
violation must sit on the offending line as a
`# schedlint: ok(determinism) <reason>` pragma, visible in review.
Non-sim core modules are scanned too, against the
`config.DETERMINISM_ALLOWLIST` (module, rule) entries — the daemon
*is* the wall-clock binding, kernel benchmarking measures real time —
so a new kind of nondeterminism in those files still surfaces.
"""
from __future__ import annotations

import ast

from repro_torch.analysis import config
from repro_torch.analysis.walker import Finding, Project, SourceModule

CHECKER = "determinism"

_RANDOM_MODULES = {"random"}
_RANDOM_ATTRS = {("jax", "random"), ("numpy", "random"),
                 ("np", "random")}
_SET_MAKERS = {"set", "frozenset"}
_SET_METHODS = {"copy", "union", "intersection", "difference",
                "symmetric_difference"}
# order-sensitive consumers of an iterable
_ORDER_SINKS = {"list", "tuple", "enumerate", "iter", "sum", "map",
                "filter", "reversed"}
_ORDER_SAFE = {"sorted", "len", "min", "max", "any", "all", "bool",
               "frozenset", "set"}


def _annotation_is_set(node) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and n.id in _SET_MAKERS:
            return True
    return False


class _ModuleScan:
    def __init__(self, project: Project, module: SourceModule,
                 strict: bool):
        self.project = project
        self.module = module
        self.strict = strict           # sim path: pragmas only
        self.findings: list[Finding] = []
        # (class, attr) known to hold sets; None class = module global
        self.set_attrs: set[tuple] = set()
        # classes whose `self` IS a set (subclasses of set)
        self.set_selves: set[str] = set()

    # -- reporting ------------------------------------------------------------

    def report(self, rule: str, line: int, msg: str) -> None:
        if self.project.pragma(self.module, line, CHECKER) is not None:
            return
        if not self.strict and (self.module.name, rule) \
                in config.DETERMINISM_ALLOWLIST:
            return
        self.findings.append(Finding(
            CHECKER, self.module.path, line, f"[{rule}] {msg}"))

    # -- pre-pass: where do sets live? ----------------------------------------

    def index_sets(self) -> None:
        for cls_name, cls in self.module.classes.items():
            for base in cls.bases:
                if isinstance(base, ast.Name) \
                        and base.id in _SET_MAKERS:
                    self.set_selves.add(cls_name)
            for node in ast.walk(cls):
                tgt = None
                if isinstance(node, ast.AnnAssign) \
                        and node.annotation is not None \
                        and _annotation_is_set(node.annotation):
                    tgt = node.target
                elif isinstance(node, ast.Assign) \
                        and self._makes_set(node.value, {}):
                    tgt = node.targets[0] \
                        if len(node.targets) == 1 else None
                if isinstance(tgt, ast.Attribute) \
                        and isinstance(tgt.value, ast.Name) \
                        and tgt.value.id == "self":
                    self.set_attrs.add((cls_name, tgt.attr))

    def _makes_set(self, expr, locals_: dict) -> bool:
        if isinstance(expr, (ast.Set, ast.SetComp)):
            return True
        if isinstance(expr, ast.Call):
            f = expr.func
            if isinstance(f, ast.Name) and f.id in _SET_MAKERS:
                return True
            if isinstance(f, ast.Attribute) \
                    and f.attr in _SET_METHODS:
                return self._is_set(f.value, locals_, None)
        if isinstance(expr, ast.BinOp) and isinstance(
                expr.op, (ast.BitOr, ast.BitAnd, ast.Sub)):
            return self._is_set(expr.left, locals_, None) \
                or self._is_set(expr.right, locals_, None)
        return False

    def _is_set(self, expr, locals_: dict, cls: str | None) -> bool:
        if isinstance(expr, ast.Name):
            if expr.id == "self" and cls in self.set_selves:
                return True
            return locals_.get(expr.id, False)
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self":
            return any((c, expr.attr) in self.set_attrs
                       for c in self.module.classes)
        return self._makes_set(expr, locals_)

    # -- the scan -------------------------------------------------------------

    def run(self) -> None:
        self.index_sets()
        for node in self.module.tree.body:
            self._imports(node)
        for node in ast.walk(self.module.tree):
            self._imports(node)
            if isinstance(node, ast.Attribute):
                self._attr(node)
            elif isinstance(node, ast.Call):
                self._call(node)
        # set iteration needs per-function local tracking; scan every
        # function exactly once, under its owning class if any
        owner: dict[int, str] = {}
        for cls_name, cls in self.module.classes.items():
            for fn in (n for n in ast.walk(cls)
                       if isinstance(n, ast.FunctionDef)):
                owner[id(fn)] = cls_name
        for fn in (n for n in ast.walk(self.module.tree)
                   if isinstance(n, ast.FunctionDef)):
            self._scan_fn(owner.get(id(fn)), fn)

    def _imports(self, node) -> None:
        if isinstance(node, ast.Import):
            for a in node.names:
                root = a.name.split(".")[0]
                if root == "time":
                    self.report("wall-clock", node.lineno,
                                "imports `time` — virtual-time code "
                                "must receive clocks as arguments")
                elif root in _RANDOM_MODULES:
                    self.report("randomness", node.lineno,
                                f"imports `{a.name}`")
        elif isinstance(node, ast.ImportFrom):
            root = (node.module or "").split(".")[0]
            if root == "time":
                self.report("wall-clock", node.lineno,
                            "imports from `time`")
            elif root in _RANDOM_MODULES:
                self.report("randomness", node.lineno,
                            f"imports from `{node.module}`")

    def _attr(self, node: ast.Attribute) -> None:
        v = node.value
        if isinstance(v, ast.Name):
            if (v.id, node.attr) in _RANDOM_ATTRS:
                self.report("randomness", node.lineno,
                            f"uses `{v.id}.{node.attr}`")
            elif v.id == "os" and node.attr in ("environ", "getenv"):
                self.report("environ", node.lineno,
                            f"reads `os.{node.attr}` — behavior must "
                            f"not depend on ambient environment")

    def _call(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Name) and f.id == "id" \
                and len(node.args) == 1:
            self.report("id-order", node.lineno,
                        "calls `id()` — object addresses vary per run; "
                        "key on stable ids (rid/aid/name) instead")

    def _scan_fn(self, cls_name, fn: ast.FunctionDef) -> None:
        locals_: dict[str, bool] = {}
        for node in sorted(
                (n for n in ast.walk(fn)
                 if isinstance(n, (ast.Assign, ast.AnnAssign))),
                key=lambda n: n.lineno):
            tgts = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            val = node.value
            if val is None:
                continue
            for t in tgts:
                if isinstance(t, ast.Name):
                    locals_[t.id] = self._is_set(val, locals_,
                                                 cls_name)
                elif isinstance(t, ast.Tuple) \
                        and isinstance(val, ast.Tuple) \
                        and len(t.elts) == len(val.elts):
                    for te, ve in zip(t.elts, val.elts):
                        if isinstance(te, ast.Name):
                            locals_[te.id] = self._is_set(
                                ve, locals_, cls_name)
        for node in ast.walk(fn):
            if isinstance(node, (ast.For, ast.AsyncFor)) \
                    and self._is_set(node.iter, locals_, cls_name):
                self.report(
                    "set-iter", node.lineno,
                    "iterates an unordered set — order can reach a "
                    "scheduling decision; iterate `sorted(...)` or an "
                    "insertion-ordered dict instead")
            elif isinstance(node, (ast.ListComp, ast.SetComp,
                                   ast.DictComp, ast.GeneratorExp)):
                for gen in node.generators:
                    if self._is_set(gen.iter, locals_, cls_name):
                        self.report(
                            "set-iter", node.lineno,
                            "comprehension over an unordered set")
            elif isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Name) \
                        and f.id in _ORDER_SINKS and node.args \
                        and self._is_set(node.args[0], locals_,
                                         cls_name):
                    self.report(
                        "set-iter", node.lineno,
                        f"`{f.id}()` over an unordered set — the "
                        f"result order is hash-dependent")
                elif isinstance(f, ast.Attribute) and f.attr == "pop" \
                        and not node.args \
                        and self._is_set(f.value, locals_, cls_name):
                    self.report(
                        "set-iter", node.lineno,
                        "`set.pop()` removes an arbitrary element")


def check_determinism(project: Project) -> list[Finding]:
    findings = project.pragma_findings(CHECKER)
    for module in project.modules.values():
        scan = _ModuleScan(project, module,
                           strict=module.name in project.sim_modules)
        scan.run()
        findings += scan.findings
    return findings
