"""Shared AST machinery for schedlint (pure stdlib, no repro imports).

The checkers never import the code they check: contracts are plain
literal constants (`TRACKED_FIELDS`, `MEMO_CONTRACTS`, ...) extracted
from the parsed source, so `python -m repro_torch.analysis` runs on a bare
CPython.  This module provides:

  - `Project`: parses a set of files, indexes classes and methods
    across modules, extracts the in-code contract declarations, and
    collects `# schedlint: ok(<checker>) <reason>` pragmas;
  - `PathEngine`: a small path-sensitive abstract interpreter over one
    function body.  It tracks, per execution path, the set of tracked
    mutation events and whether a version bump happened anywhere on
    that path (a bump on a path covers every mutation of that path —
    within one method there is no interleaved cache read, so bump
    order inside the method does not matter; see
    docs/static_analysis.md).  Aliases of tracked fields through
    locals (`req = self.requests[rid]`), subscripts, `.get()`/
    `.values()` chains, tuple unpacking and `for` targets are
    followed; receiver classes are inferred from a declared type map
    so cross-object mutations (`vst.steal_pending(...)` in fabric
    methods) resolve to interprocedural method summaries.

Soundness posture: the engine is deliberately conservative where the
AST runs out of information (unknown calls are ignored, merged branch
states keep every possibility) and coarse where precision would not
pay (clearing is per-path, not per-receiver).  The runtime sanitizer
(sanitizer.py) covers the dynamic gap.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Iterable, Optional

# declarations extracted from checked sources when present
_DECL_NAMES = (
    "TRACKED_FIELDS", "TRACKED_MUTATORS", "EXTERNAL_MUTATORS",
    "UNTRACKED_FIELDS", "TRACKED_CLASS", "MEMO_CONTRACTS",
    "CKPT_MUTATORS", "SCHEDLINT_SIM", "SCHEDLINT_TYPES",
    "SCHEDLINT_VERSIONED", "SCHEDLINT_SAFE_ATTRS",
)

_PRAGMA_RE = re.compile(
    r"#\s*schedlint:\s*ok\((?P<checker>[a-z]+)\)\s*(?P<reason>.*)")

# bounded path explosion: beyond this many states per program point the
# engine merges pairwise (union events, AND cleared) — conservative
_MAX_STATES = 64


@dataclasses.dataclass(frozen=True)
class Finding:
    checker: str
    file: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.file}:{self.line}: [{self.checker}] {self.message}"


class SourceModule:
    """One parsed file: AST, class index, declarations, pragmas."""

    def __init__(self, path: str):
        self.path = str(path)
        self.name = Path(path).stem
        src = Path(path).read_text()
        self.tree = ast.parse(src, filename=self.path)
        self.classes: dict[str, ast.ClassDef] = {}
        self.decls: dict[str, object] = {}
        for node in self.tree.body:
            if isinstance(node, ast.ClassDef):
                self.classes[node.name] = node
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id in _DECL_NAMES:
                try:
                    self.decls[node.targets[0].id] = \
                        ast.literal_eval(node.value)
                except ValueError:
                    pass               # non-literal: not a declaration
        # line -> {checker: reason}; "" reason is itself reported.
        # A pragma on its own (comment) line attaches forward to the
        # next code line, so multi-line justifications work:
        #     # schedlint: ok(determinism) reason, possibly
        #     # wrapping onto further comment lines
        #     for i in tuple(self): ...
        self.pragmas: dict[int, dict[str, str]] = {}
        lines = src.splitlines()
        for i, line in enumerate(lines, start=1):
            m = _PRAGMA_RE.search(line)
            if m is None:
                continue
            entry = {m.group("checker"): m.group("reason").strip()}
            self.pragmas.setdefault(i, {}).update(entry)
            if line.lstrip().startswith("#"):
                for j in range(i, len(lines)):
                    nxt = lines[j].strip()
                    if nxt and not nxt.startswith("#"):
                        self.pragmas.setdefault(j + 1, {}).update(entry)
                        break

    def methods(self, cls: str) -> dict[str, ast.FunctionDef]:
        node = self.classes.get(cls)
        if node is None:
            return {}
        return {n.name: n for n in node.body
                if isinstance(n, ast.FunctionDef)}


class Project:
    """A set of parsed modules plus the merged contract declarations."""

    def __init__(self, paths: Iterable[str], sim_modules=None):
        from repro_torch.analysis import config
        self.modules: dict[str, SourceModule] = {}
        for p in paths:
            m = SourceModule(p)
            self.modules[m.name] = m
        # merged declarations: config defaults, then in-file literals
        self.tracked: tuple = config.TRACKED_FALLBACK
        self.mutators: set[str] = set(config.MUTATORS_FALLBACK)
        self.external: set[str] = set()
        self.untracked: dict[str, str] = {}
        self.state_classes: set[str] = set()
        self.memo_contracts: list[dict] = []
        self.ckpt_mutators: set[str] = set()
        self.types: dict = dict(config.TYPE_HINTS)
        self.versioned: dict = dict(config.VERSIONED)
        self.safe_attrs: dict = {k: set(v)
                                 for k, v in config.SAFE_ATTRS.items()}
        declared_sim = set()
        for m in self.modules.values():
            d = m.decls
            if "TRACKED_FIELDS" in d:
                self.tracked = tuple(d["TRACKED_FIELDS"])
                self.state_classes.add(
                    d.get("TRACKED_CLASS", config.STATE_CLASS))
            if "TRACKED_MUTATORS" in d:
                self.mutators = set(d["TRACKED_MUTATORS"])
            if "EXTERNAL_MUTATORS" in d:
                self.external |= set(d["EXTERNAL_MUTATORS"])
            if "UNTRACKED_FIELDS" in d:
                self.untracked.update(d["UNTRACKED_FIELDS"])
            if "CKPT_MUTATORS" in d:
                self.ckpt_mutators |= set(d["CKPT_MUTATORS"])
            if "MEMO_CONTRACTS" in d:
                for c in d["MEMO_CONTRACTS"]:
                    self.memo_contracts.append(
                        dict(c, _module=m.name))
            if d.get("SCHEDLINT_SIM"):
                declared_sim.add(m.name)
            for key, val in (d.get("SCHEDLINT_TYPES") or {}).items():
                self.types[tuple(key.split("."))
                           if "." in key else key] = val
            for key, val in (d.get("SCHEDLINT_VERSIONED") or {}).items():
                cls, attr = key.split(".")
                self.versioned[(cls, attr)] = val
            for key in (d.get("SCHEDLINT_SAFE_ATTRS") or ()):
                cls, attr = key.split(".")
                self.safe_attrs.setdefault(cls, set()).add(attr)
        if not self.state_classes:
            self.state_classes = {config.STATE_CLASS}
        if sim_modules is not None:
            self.sim_modules = set(sim_modules)
        else:
            self.sim_modules = (set(config.SIM_MODULES)
                                & set(self.modules)) | declared_sim

    # -- cross-module lookups -------------------------------------------------

    def find_class(self, cls: str) -> Optional[tuple[SourceModule,
                                                     ast.ClassDef]]:
        for m in self.modules.values():
            if cls in m.classes:
                return m, m.classes[cls]
        return None

    def find_method(self, cls: str, name: str) \
            -> Optional[tuple[SourceModule, ast.FunctionDef]]:
        hit = self.find_class(cls)
        if hit is None:
            return None
        m, _ = hit
        fn = m.methods(cls).get(name)
        return None if fn is None else (m, fn)

    def pragma(self, module: SourceModule, line: int,
               checker: str) -> Optional[str]:
        """The justification of a `# schedlint: ok(checker)` pragma on
        `line` (or the line above it), else None."""
        for ln in (line, line - 1):
            entry = module.pragmas.get(ln)
            if entry and checker in entry:
                return entry[checker]
        return None

    def pragma_findings(self, checker: str) -> list[Finding]:
        """Pragmas with an empty justification are findings themselves:
        the allowlist policy requires every exception to say why."""
        out = []
        for m in self.modules.values():
            for line, entry in m.pragmas.items():
                if entry.get(checker) == "":
                    out.append(Finding(
                        checker, m.path, line,
                        "schedlint pragma without a justification — "
                        "every intentional exception must say why it "
                        "is safe (docs/static_analysis.md)"))
        return out


# -- type inference -----------------------------------------------------------

class Typer:
    """Coarse receiver-class inference from the declared type map.

    `project.types` maps a bare name ("st") or an (owner-class, attr)
    pair (("Fabric", "states") for container element types) to a class
    name.  Locals pick up types flow-insensitively from assignments.
    """

    def __init__(self, project: Project, owner: str):
        self.project = project
        self.owner = owner
        self.locals: dict[str, str] = {}

    def of(self, expr: ast.AST) -> Optional[str]:
        if isinstance(expr, ast.Name):
            if expr.id == "self":
                return self.owner
            if expr.id in self.locals:
                return self.locals[expr.id]
            hint = self.project.types.get(expr.id)
            return hint if isinstance(hint, str) else None
        if isinstance(expr, ast.Attribute):
            base = self.of(expr.value)
            if base is not None:
                hint = self.project.types.get((base, expr.attr))
                if isinstance(hint, str):
                    return hint
            return None
        if isinstance(expr, ast.Subscript):
            # elements of a typed container share its declared type
            return self.of(expr.value)
        if isinstance(expr, ast.Call):
            f = expr.func
            if isinstance(f, ast.Attribute) and f.attr in (
                    "get", "values", "pop", "setdefault", "items"):
                return self.of(f.value)
        return None

    def assign(self, target: ast.AST, value: ast.AST) -> None:
        if isinstance(target, ast.Name):
            t = self.of(value)
            if t is not None:
                self.locals[target.id] = t
            else:
                self.locals.pop(target.id, None)
        elif isinstance(target, (ast.Tuple, ast.List)):
            if isinstance(value, (ast.Tuple, ast.List)) \
                    and len(value.elts) == len(target.elts):
                for tgt, val in zip(target.elts, value.elts):
                    self.assign(tgt, val)
            else:
                # `for k, v in d.items()` / unpacking one typed source:
                # give every element the source's (element) type —
                # coarse, but keys are rarely dereferenced
                for tgt in target.elts:
                    self.assign(tgt, value)


# -- the path engine ----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Event:
    """One tracked mutation on some execution path."""
    field: str
    line: int
    recv: str          # source-ish receiver label, for messages
    note: str = ""     # e.g. "via self._pop_finished"


@dataclasses.dataclass(frozen=True)
class PathState:
    events: frozenset    # of Event
    cleared: bool        # a version bump happened on this path


@dataclasses.dataclass
class Summary:
    """Interprocedural method summary under one clearing mode."""
    exposed: frozenset           # Events reaching exit on uncleared paths
    always_clears: bool          # every path through bumps the version
    returns_alias: frozenset     # tracked fields the return may alias


def _recv_label(expr: ast.AST) -> str:
    try:
        return ast.unparse(expr)
    except Exception:                              # pragma: no cover
        return "<expr>"


class PathEngine:
    """Path-sensitive mutation/clearing analysis for one class's
    methods, with interprocedural summaries (memoized, cycle-safe).

    `mode` selects what counts as clearing: "bump" accepts `_touch`,
    `_bump` and a direct `_version` augassign; "touch" accepts only
    `_touch` (the external-entry-point rule — a bare bump moves the
    version without firing `on_change`, so the fabric's dirty set
    never learns of the mutation).
    """

    def __init__(self, project: Project, mode: str = "bump"):
        self.project = project
        self.mode = mode
        self._summaries: dict[tuple[str, str], Summary] = {}
        self._in_progress: set[tuple[str, str]] = set()

    # -- summaries ------------------------------------------------------------

    def summary(self, cls: str, method: str) -> Summary:
        key = (cls, method)
        if key in self._summaries:
            return self._summaries[key]
        if key in self._in_progress:       # recursion: be conservative
            return Summary(frozenset(), False, frozenset())
        if method in ("_touch",):
            s = Summary(frozenset(), True, frozenset())
        elif method in ("_bump",):
            s = Summary(frozenset(), self.mode == "bump", frozenset())
        else:
            hit = self.project.find_method(cls, method)
            if hit is None:
                return Summary(frozenset(), False, frozenset())
            self._in_progress.add(key)
            try:
                s = self._analyze(cls, method, hit[1])
            finally:
                self._in_progress.discard(key)
        self._summaries[key] = s
        return s

    def _analyze(self, cls: str, method: str,
                 fn: ast.FunctionDef) -> Summary:
        walk = _FunctionWalk(self, cls, fn)
        exits = walk.run()
        exposed = frozenset(
            ev for s in exits if not s.cleared for ev in s.events)
        always = all(s.cleared for s in exits) and bool(exits)
        return Summary(exposed, always, frozenset(walk.return_alias))


class _FunctionWalk:
    """One function body under the path engine."""

    def __init__(self, engine: PathEngine, cls: str,
                 fn: ast.FunctionDef):
        self.engine = engine
        self.project = engine.project
        self.cls = cls
        self.fn = fn
        self.typer = Typer(engine.project, cls)
        # local name -> frozenset of tracked field names it may alias
        self.aliases: dict[str, frozenset] = {}
        self.return_alias: set = set()
        self.exit_states: list[PathState] = []

    # -- driver ---------------------------------------------------------------

    def run(self) -> list[PathState]:
        states = {PathState(frozenset(), False)}
        states = self.stmts(self.fn.body, states)
        self.exit_states.extend(states)     # fall-through exit
        return self.exit_states

    def _merge(self, states: set) -> set:
        if len(states) <= _MAX_STATES:
            return states
        all_events = frozenset(
            ev for s in states for ev in s.events)
        return {PathState(all_events, all(s.cleared for s in states))}

    def stmts(self, body, states: set) -> set:
        for stmt in body:
            states = self.stmt(stmt, states)
            if not states:
                break                        # all paths exited
        return states

    # -- statements -----------------------------------------------------------

    def stmt(self, node: ast.stmt, states: set) -> set:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return states                    # nested defs: out of scope
        if isinstance(node, ast.Return):
            if node.value is not None:
                states = self.expr(node.value, states, node)
                self.return_alias |= self.alias_of(node.value)
            self.exit_states.extend(states)
            return set()
        if isinstance(node, ast.Raise):
            # an exceptional exit: tracked mutations before a raise are
            # still mutations the caller may observe
            if node.exc is not None:
                states = self.expr(node.exc, states, node)
            self.exit_states.extend(states)
            return set()
        if isinstance(node, (ast.Break, ast.Continue)):
            # approximated: treated as falling through to after-loop
            return states
        if isinstance(node, ast.Assign):
            states = self.expr(node.value, states, node)
            for t in node.targets:
                states = self.target(t, states, node)
                self.typer.assign(t, node.value)
                self.alias_assign(t, node.value)
            return states
        if isinstance(node, ast.AnnAssign):
            if node.value is not None:
                states = self.expr(node.value, states, node)
                states = self.target(node.target, states, node)
                self.typer.assign(node.target, node.value)
                self.alias_assign(node.target, node.value)
            return states
        if isinstance(node, ast.AugAssign):
            states = self.expr(node.value, states, node)
            # `self._version += 1` is the primitive bump
            t = node.target
            if self.engine.mode == "bump" \
                    and isinstance(t, ast.Attribute) \
                    and isinstance(t.value, ast.Name) \
                    and t.value.id == "self" and t.attr == "_version" \
                    and self.cls in self.project.state_classes:
                return {PathState(s.events, True) for s in states}
            return self.target(t, states, node)
        if isinstance(node, ast.Delete):
            for t in node.targets:
                states = self.target(t, states, node)
            return states
        if isinstance(node, ast.Expr):
            return self.expr(node.value, states, node)
        if isinstance(node, ast.If):
            states = self.expr(node.test, states, node)
            a = self.stmts(node.body, set(states))
            b = self.stmts(node.orelse, set(states))
            return self._merge(a | b)
        if isinstance(node, (ast.For, ast.AsyncFor)):
            states = self.expr(node.iter, states, node)
            self.typer.assign(node.target, node.iter)
            self.alias_assign(node.target, node.iter)
            # body 0, 1 or 2+ times: two unrollings reach the fixpoint
            # of the (events, cleared) lattice for straight-line bodies
            once = self.stmts(node.body, set(states))
            twice = self.stmts(node.body, set(once))
            after = self._merge(states | once | twice)
            return self.stmts(node.orelse, after)
        if isinstance(node, ast.While):
            states = self.expr(node.test, states, node)
            once = self.stmts(node.body, set(states))
            twice = self.stmts(node.body, set(once))
            after = self._merge(states | once | twice)
            return self.stmts(node.orelse, after)
        if isinstance(node, ast.Try):
            body_out = self.stmts(node.body, set(states))
            handler_out = set()
            for h in node.handlers:
                # coarse: a handler may run from any prefix of the body
                handler_out |= self.stmts(
                    h.body, self._merge(set(states) | body_out))
            out = self._merge(body_out | handler_out)
            out = self.stmts(node.orelse, out)
            return self.stmts(node.finalbody, out)
        if isinstance(node, ast.With):
            for item in node.items:
                states = self.expr(item.context_expr, states, node)
            return self.stmts(node.body, states)
        if isinstance(node, (ast.Assert,)):
            return self.expr(node.test, states, node)
        if isinstance(node, (ast.Pass, ast.Import, ast.ImportFrom,
                             ast.Global, ast.Nonlocal)):
            return states
        # anything else: walk child expressions conservatively
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                states = self.expr(child, states, node)
        return states

    # -- mutation targets -----------------------------------------------------

    def target(self, t: ast.AST, states: set, stmt: ast.stmt) -> set:
        """An assignment/del/augassign target: attribute or subscript
        writes into tracked state become events."""
        fields, recv = self.fields_written(t)
        for f in fields:
            states = self.add_event(states, f, stmt.lineno, recv)
        return states

    def fields_written(self, t: ast.AST) -> tuple[set, str]:
        if isinstance(t, ast.Attribute):
            base = t.value
            # self.FIELD = ... / stobj.FIELD = ...
            base_cls = self.typer.of(base)
            if base_cls in self.project.state_classes:
                if t.attr in self.project.tracked:
                    return {t.attr}, _recv_label(base)
                # unknown attrs are the registry-completeness scan's
                # job (mutation.py), not a path-sensitive question
                return set(), ""
            # req.failed = ... — attribute write through an alias
            al = self.alias_of(base)
            if al:
                return set(al), _recv_label(base)
            return set(), ""
        if isinstance(t, ast.Subscript):
            # self.FIELD[k] = ... / alias[k] = ...
            al = self.alias_of(t.value)
            if al:
                return set(al), _recv_label(t.value)
            return set(), ""
        if isinstance(t, (ast.Tuple, ast.List)):
            fields, recv = set(), ""
            for el in t.elts:
                f, r = self.fields_written(el)
                fields |= f
                recv = recv or r
            return fields, recv
        return set(), ""

    def add_event(self, states: set, field: str, line: int,
                  recv: str, note: str = "") -> set:
        ev = Event(field, line, recv, note)
        return {PathState(s.events | {ev}, s.cleared) for s in states}

    # -- expressions ----------------------------------------------------------

    def expr(self, node: ast.expr, states: set, stmt: ast.stmt) -> set:
        """Walk an expression: calls may mutate (mutator methods on
        tracked aliases), clear (touch/bump and always-clearing
        methods) or import a callee's exposed events."""
        for call in [n for n in ast.walk(node)
                     if isinstance(n, ast.Call)]:
            states = self.call(call, states, stmt)
        return states

    def call(self, call: ast.Call, states: set,
             stmt: ast.stmt) -> set:
        f = call.func
        if not isinstance(f, ast.Attribute):
            return states
        recv, name = f.value, f.attr
        recv_cls = self.typer.of(recv)
        line = getattr(call, "lineno", stmt.lineno)
        # 1. the clearing primitives and analyzed-method calls
        if recv_cls in self.project.state_classes:
            s = self.engine.summary(recv_cls, name)
            for ev in s.exposed:
                states = self.add_event(
                    states, ev.field, line, _recv_label(recv),
                    note=f"via {recv_cls}.{name} (line {ev.line})")
            if s.always_clears:
                return {PathState(st.events, True) for st in states}
            if name in self.project.mutators:
                al = self.alias_of(recv)
                for fld in al:
                    states = self.add_event(states, fld, line,
                                            _recv_label(recv))
            return states
        # 2. checkpoint-manager mutators piggyback on state versions
        if recv_cls == "CheckpointManager" \
                and name in self.project.ckpt_mutators:
            return self.add_event(
                states, "ckpt(shared)", line, _recv_label(recv),
                note="checkpoint records are versioned by the owning "
                     "shell's _version (checkpoint.py CKPT_MUTATORS)")
        # 3. mutator methods on aliases of tracked fields
        if name in self.project.mutators:
            al = self.alias_of(recv)
            for fld in al:
                states = self.add_event(states, fld, line,
                                        _recv_label(recv))
        # 4. calls into other analyzed classes (e.g. fixture helpers)
        if recv_cls is not None \
                and recv_cls not in ("CheckpointManager",):
            s = self.engine.summary(recv_cls, name)
            for ev in s.exposed:
                states = self.add_event(
                    states, ev.field, line, _recv_label(recv),
                    note=f"via {recv_cls}.{name} (line {ev.line})")
            if s.always_clears:
                states = {PathState(st.events, True) for st in states}
        return states

    # -- aliases --------------------------------------------------------------

    def alias_of(self, expr: ast.AST) -> frozenset:
        """Tracked fields `expr` may refer into (coarse, transitive)."""
        if isinstance(expr, ast.Name):
            if expr.id == "self":
                return frozenset()
            return self.aliases.get(expr.id, frozenset())
        if isinstance(expr, ast.Attribute):
            base_cls = self.typer.of(expr.value)
            if base_cls in self.project.state_classes \
                    and expr.attr in self.project.tracked:
                return frozenset({expr.attr})
            return self.alias_of(expr.value)
        if isinstance(expr, ast.Subscript):
            return self.alias_of(expr.value)
        if isinstance(expr, ast.Call):
            f = expr.func
            if isinstance(f, ast.Attribute):
                recv_cls = self.typer.of(f.value)
                if recv_cls in self.project.state_classes:
                    return self.engine.summary(
                        recv_cls, f.attr).returns_alias
                return self.alias_of(f.value)
            if isinstance(f, ast.Name) and f.id in (
                    "sorted", "list", "tuple", "reversed", "iter",
                    "next", "min", "max"):
                out = frozenset()
                for a in expr.args:
                    out |= self.alias_of(a)
                return out
            return frozenset()
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            out = frozenset()
            for el in expr.elts:
                out |= self.alias_of(el)
            return out
        if isinstance(expr, (ast.IfExp,)):
            return self.alias_of(expr.body) | self.alias_of(expr.orelse)
        if isinstance(expr, ast.BoolOp):
            out = frozenset()
            for v in expr.values:
                out |= self.alias_of(v)
            return out
        if isinstance(expr, ast.Starred):
            return self.alias_of(expr.value)
        if isinstance(expr, (ast.ListComp, ast.SetComp,
                             ast.GeneratorExp)):
            out = frozenset()
            for gen in expr.generators:
                out |= self.alias_of(gen.iter)
            return out
        return frozenset()

    def alias_assign(self, target: ast.AST, value: ast.AST) -> None:
        al = self.alias_of(value)
        if isinstance(target, ast.Name):
            if al:
                self.aliases[target.id] = al
            else:
                self.aliases.pop(target.id, None)
        elif isinstance(target, (ast.Tuple, ast.List)):
            vals = value.elts if isinstance(
                value, (ast.Tuple, ast.List)) else None
            for i, tgt in enumerate(target.elts):
                self.alias_assign(
                    tgt, vals[i] if vals and i < len(vals) else value)
