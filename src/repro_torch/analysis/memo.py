"""Checker 2: memo-fingerprint completeness.

The incremental core elides recomputation through memo caches — the
backlog estimate (`Fabric._backlog_cache`), the failed-steal
fingerprint (`Fabric._steal_fail`), the demand memo
(`ArrivalEstimator._demand`).  Each is sound only if its key covers
*every* piece of versioned state the cached computation reads: one
uncovered read and a stale value survives a state change, and the
byte-identity with the reschedule-everything core is gone.

The contracts live next to the caches as `MEMO_CONTRACTS` literals:

    MEMO_CONTRACTS = (
        {"name": "backlog_ms", "func": "Fabric._backlog_ms",
         "cache": "_backlog_cache", "key": ("state", "cost"),
         "folded": {}},
        ...)

`key` lists the version tokens the cache key covers (see
analysis/config.py VERSIONED for the token model); `folded` declares
tokens that are covered *indirectly* — e.g. the steal fingerprint
never keys on the arrival estimator directly, but every shell's
reservation is resampled from it each event, so arrival changes are
folded into `_reserve_last` — each with a written justification.

The checker walks the cached computation and everything it calls
(cross-module, cycle-safe), classifies every attribute read through
the declared receiver types, and reports any read whose token the key
does not cover.  Reads through receivers the type map cannot resolve
(locals holding tuple payloads etc.) are skipped unless the attribute
name is on the Request/Assignment surface — the realistic regression
is a new read of `self.*` or a typed shell/state attribute, and those
always classify.  Calls *into* another declared contract count as
reading that contract's key tokens.
"""
from __future__ import annotations

import ast

from repro_torch.analysis import config
from repro_torch.analysis.walker import Finding, Project, SourceModule, Typer

CHECKER = "memo"

KNOWN_TOKENS = frozenset({
    "state", "cost", "arrivals", "reserve", "now", "tenant_service",
    "args", "net",
})


class _ReadCollector:
    """Transitive attribute-read classification for one contract."""

    def __init__(self, project: Project):
        self.project = project
        self.contract_keys: dict[tuple[str, str], tuple] = {}
        # the cache attribute itself is memo storage, not versioned
        # state: reading it is what makes the function a memo
        self.cache_attrs: set[tuple[str, str]] = set()
        for c in project.memo_contracts:
            cls, _, meth = c["func"].rpartition(".")
            self.contract_keys[(cls, meth)] = tuple(c["key"])
            self.cache_attrs.add((cls, c["cache"]))
        self._done: set[tuple[str, str]] = set()
        # (token, label, file, line)
        self.reads: list[tuple] = []

    def collect(self, cls: str, method: str) -> None:
        key = (cls, method)
        if key in self._done:
            return
        self._done.add(key)
        hit = self.project.find_method(cls, method)
        if hit is None:
            return
        module, fn = hit
        typer = Typer(self.project, cls)
        for node in sorted(
                [n for n in ast.walk(fn)
                 if isinstance(n, (ast.Assign, ast.For))],
                key=lambda n: n.lineno):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    typer.assign(t, node.value)
            else:
                typer.assign(node.target, node.iter)
        now_params = {a.arg for a in fn.args.args if a.arg == "now"}
        # an Attribute that is a call's func is a method *invocation*,
        # handled by the Call branch (descend / contract tokens), not
        # an attribute read
        call_funcs = {id(n.func) for n in ast.walk(fn)
                      if isinstance(n, ast.Call)}
        for node in ast.walk(fn):
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.ctx, ast.Load) \
                    and id(node) not in call_funcs:
                self._classify(module, cls, typer, node)
            elif isinstance(node, ast.Name) \
                    and isinstance(node.ctx, ast.Load) \
                    and node.id in now_params:
                self.reads.append(("now", f"parameter '{node.id}'",
                                   module.path, node.lineno))
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute):
                recv_cls = typer.of(node.func.value)
                if recv_cls is None:
                    continue
                callee = (recv_cls, node.func.attr)
                if callee in self.contract_keys and callee != key:
                    for tok in self.contract_keys[callee]:
                        self.reads.append((
                            tok,
                            f"call into memoized "
                            f"{recv_cls}.{node.func.attr} (keys on "
                            f"'{tok}')", module.path, node.lineno))
                elif self._is_mutator(callee):
                    # a state-mutating call marks the *non-cached*
                    # outcome (e.g. the steal success path re-submits;
                    # the fingerprint caches failed scans only): its
                    # body computes no part of the memoized value, and
                    # the mutation checker separately guarantees it
                    # bumps the versions the key reads
                    continue
                elif self.project.find_method(*callee):
                    self.collect(*callee)

    def _is_mutator(self, callee: tuple[str, str]) -> bool:
        cls, name = callee
        if name in ("_touch", "_bump"):
            return True
        if cls in self.project.state_classes \
                and name in self.project.external:
            return True
        return cls == "CheckpointManager" \
            and name in self.project.ckpt_mutators

    def _classify(self, module: SourceModule, cls: str, typer: Typer,
                  node: ast.Attribute) -> None:
        recv_cls = typer.of(node.value)
        attr = node.attr
        label = f"{recv_cls or '<untyped>'}.{attr}"
        if recv_cls is not None:
            if recv_cls in self.project.state_classes \
                    and attr in self.project.tracked:
                self.reads.append(("state", label, module.path,
                                   node.lineno))
                return
            if (recv_cls, attr) in self.project.types:
                return                        # typed traversal edge
            if (recv_cls, attr) in self.cache_attrs:
                return                        # the memo storage itself
            if (recv_cls, attr) in self.project.versioned:
                tok = self.project.versioned[(recv_cls, attr)]
                if tok is not None:
                    self.reads.append((tok, label, module.path,
                                       node.lineno))
                return
            if attr in config.REQUEST_ATTRS:
                self.reads.append(("state", label, module.path,
                                   node.lineno))
                return
            if attr.startswith("__"):
                return
            self.reads.append(
                (f"?", label, module.path, node.lineno))
            return
        if attr in config.REQUEST_ATTRS:
            self.reads.append(("state", label, module.path,
                               node.lineno))


def check_memo(project: Project) -> list[Finding]:
    findings = project.pragma_findings(CHECKER)
    for contract in project.memo_contracts:
        cmod = project.modules[contract["_module"]]
        cls, _, meth = contract["func"].rpartition(".")
        name = contract.get("name", contract["func"])
        hit = project.find_method(cls, meth)
        if hit is None:
            findings.append(Finding(
                CHECKER, cmod.path, 1,
                f"memo contract '{name}' names {contract['func']}, "
                f"which does not exist"))
            continue
        bad_tokens = set(contract["key"]) - KNOWN_TOKENS
        for tok in sorted(bad_tokens):
            findings.append(Finding(
                CHECKER, cmod.path, 1,
                f"memo contract '{name}' keys on unknown token "
                f"'{tok}' (known: {sorted(KNOWN_TOKENS)})"))
        folded = contract.get("folded", {}) or {}
        for tok, why in sorted(folded.items()):
            if not str(why).strip():
                findings.append(Finding(
                    CHECKER, cmod.path, 1,
                    f"memo contract '{name}' folds token '{tok}' "
                    f"without a justification — folding is an "
                    f"argument, write it down"))
        covered = set(contract["key"]) | set(folded) | {"args"}
        col = _ReadCollector(project)
        col.collect(cls, meth)
        seen = set()
        for tok, label, path, line in col.reads:
            if tok in covered or (tok, label, line) in seen:
                continue
            seen.add((tok, label, line))
            if project.pragma(project.modules[
                    _mod_of(project, path)], line, CHECKER) is not None:
                continue
            if tok == "?":
                findings.append(Finding(
                    CHECKER, path, line,
                    f"memoized '{name}' ({contract['func']}) reads "
                    f"{label}, which has no versioned-state "
                    f"classification — add it to "
                    f"analysis/config.VERSIONED (or a SCHEDLINT_"
                    f"VERSIONED declaration) so the key can be "
                    f"checked against it"))
            else:
                findings.append(Finding(
                    CHECKER, path, line,
                    f"memoized '{name}' ({contract['func']}) reads "
                    f"{label} (token '{tok}') but its cache key "
                    f"{contract['key']} does not cover '{tok}': a "
                    f"stale hit survives that state changing "
                    f"(docs/static_analysis.md, invariant 2)"))
    return findings


def _mod_of(project: Project, path: str) -> str:
    for name, m in project.modules.items():
        if m.path == path:
            return name
    raise KeyError(path)
