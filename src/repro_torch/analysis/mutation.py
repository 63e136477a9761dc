"""Checker 1: mutation-tracking completeness.

The dirty-shell invariant (docs/simulator.md) holds only if every
mutation of a tracked `SchedulerState` field is accompanied by a
version bump on the same execution path — otherwise the incremental
fabric keeps treating the shell as a scheduling fixpoint and silently
diverges from `full_reschedule`.  This checker proves the lexical side
of that contract:

  1. **registry completeness** — every attribute a state-class method
     assigns must be declared, either in `TRACKED_FIELDS` or in
     `UNTRACKED_FIELDS` with a written justification.  An undeclared
     field is a finding: nobody has argued why the dirty-set can
     ignore it.
  2. **path coverage** — for every *public* method (of the state class
     and of every orchestrating class, e.g. `Fabric`), no tracked
     mutation event may reach the method's exit on a path with no
     `_touch()`/`_bump()`.  Private helpers may expose mutations;
     they are checked at their public callers through interprocedural
     summaries.
  3. **external discipline** — methods listed in `EXTERNAL_MUTATORS`
     are called *between* scheduling passes (by executors, the fabric,
     tests); a bare `_bump()` there moves the version without firing
     `on_change`, so the fabric's dirty set never learns of the
     change.  These methods are re-checked under a stricter mode where
     only `_touch()` clears.

Intentional exceptions carry a `# schedlint: ok(mutation) <reason>`
pragma on the offending line.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.walker import Finding, PathEngine, Project, Typer

CHECKER = "mutation"


def _is_public(name: str) -> bool:
    return not name.startswith("_") or name == "schedule"


def _store_targets(fn: ast.FunctionDef):
    """Yield (node, attr) for every `self.X = ...`-shaped store."""
    for node in ast.walk(fn):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        elif isinstance(node, ast.Delete):
            targets = node.targets
        for t in targets:
            for el in (t.elts if isinstance(t, (ast.Tuple, ast.List))
                       else [t]):
                tgt = el
                # `self.X[k] = v` mutates X just as `self.X = v` does
                while isinstance(tgt, ast.Subscript):
                    tgt = tgt.value
                if isinstance(tgt, ast.Attribute) \
                        and isinstance(tgt.value, ast.Name) \
                        and tgt.value.id == "self":
                    yield node, tgt.attr


def _registry_findings(project: Project, module, cls) -> list[Finding]:
    """Rule 1: every assigned state attribute is declared somewhere."""
    out = []
    known = set(project.tracked) | set(project.untracked)
    for name, fn in module.methods(cls).items():
        if name == "__init__":
            continue          # constructors build fresh, unshared state
        for node, attr in _store_targets(fn):
            if attr in known:
                continue
            if project.pragma(module, node.lineno, CHECKER) is not None:
                continue
            out.append(Finding(
                CHECKER, module.path, node.lineno,
                f"{cls}.{name} assigns undeclared field "
                f"'self.{attr}': add it to TRACKED_FIELDS (the "
                f"dirty-shell invariant depends on it) or to "
                f"UNTRACKED_FIELDS with a justification"))
    return out


def _exposure_findings(project: Project, module, cls, method,
                       engine: PathEngine, mode_msg: str) \
        -> list[Finding]:
    out = []
    for ev in sorted(engine.summary(cls, method).exposed,
                     key=lambda e: (e.line, e.field)):
        if project.pragma(module, ev.line, CHECKER) is not None:
            continue
        via = f" ({ev.note})" if ev.note else ""
        out.append(Finding(
            CHECKER, module.path, ev.line,
            f"{cls}.{method}: mutation of tracked field '{ev.field}' "
            f"on '{ev.recv}'{via} can reach the method's exit "
            f"{mode_msg} — the fabric would keep treating the shell "
            f"as a scheduling fixpoint (docs/static_analysis.md, "
            f"invariant 1)"))
    return out


def check_mutation(project: Project) -> list[Finding]:
    findings = project.pragma_findings(CHECKER)
    if not project.tracked:
        return findings               # nothing declared, nothing to do
    bump = PathEngine(project, mode="bump")
    touch = PathEngine(project, mode="touch")
    for module in project.modules.values():
        for cls in module.classes:
            is_state = cls in project.state_classes
            if is_state:
                findings += _registry_findings(project, module, cls)
            for name in module.methods(cls):
                if name.startswith("__") or name in ("_touch", "_bump"):
                    continue
                # rule 2: public entry points leave no uncovered path
                if _is_public(name) or (is_state and
                                        name in project.external):
                    findings += _exposure_findings(
                        project, module, cls, name, bump,
                        "with no _touch()/_bump() on that path")
                # rule 3: external entry points must fire on_change
                if is_state and name in project.external:
                    findings += _exposure_findings(
                        project, module, cls, name, touch,
                        "with no _touch() on that path (a bare _bump "
                        "moves the version but never fires on_change, "
                        "so the fabric's dirty set misses it)")
    # declared external mutators must exist on some state class
    for name in sorted(project.external):
        if not any(project.find_method(cls, name)
                   for cls in project.state_classes):
            for m in project.modules.values():
                if "EXTERNAL_MUTATORS" in m.decls:
                    findings.append(Finding(
                        CHECKER, m.path, 1,
                        f"EXTERNAL_MUTATORS declares '{name}' but no "
                        f"state class defines it"))
                    break
    return findings
