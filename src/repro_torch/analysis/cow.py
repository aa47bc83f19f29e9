"""Copy-on-write discipline lint.

The catalog maps that snapshots capture by reference (``Store._relations``,
``Store._fds``) are **replace-only**: a mutation must build a new dict and
swap the attribute, never edit in place — an in-place edit is visible
through every live snapshot and silently breaks snapshot isolation even
when it happens under the mutate lock.  This pass flags, anywhere in the
scanned tree:

* ``obj.<cow>[k] = v`` / ``del obj.<cow>[k]`` — in-place subscript edits;
* ``obj.<cow>.update/pop/setdefault/clear/popitem(...)`` — mutator calls;
* rebinding a replace-only dataclass field after construction
  (``fd.mapping = ...`` instead of ``dataclasses.replace(fd, ...)``);
* ``object.__setattr__(...)`` — the frozen-dataclass bypass.

Constructors are exempt (``__init__``/``__post_init__`` run before the
object is shared) and ``# lockcheck: <reason>`` suppressions apply as in
:mod:`repro_torch.analysis.lockcheck`.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Optional, Sequence

from .contracts import Contracts, DEFAULT_CONTRACTS
from .lockcheck import Finding, _dotted, _suppressed

_DICT_MUTATORS = frozenset({
    "update", "pop", "setdefault", "clear", "popitem",
})


class _CowVisitor(ast.NodeVisitor):
    def __init__(self, path: str, source: str, contracts: Contracts) -> None:
        self.path = path
        self.lines = source.splitlines()
        self.c = contracts
        self.findings: List[Finding] = []
        self._scope: List[str] = []
        self._class: List[str] = []

    # -- scope tracking ----------------------------------------------------

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class.append(node.name)
        self.generic_visit(node)
        self._class.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._scope.append(node.name)
        self.generic_visit(node)
        self._scope.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def _scope_name(self) -> str:
        parts = self._class[-1:] + self._scope[-1:]
        return ".".join(parts) if parts else "<module>"

    def _in_constructor(self) -> bool:
        return bool(self._scope) and (
            self._scope[-1] in self.c.constructor_scopes)

    # -- COW map mutations -------------------------------------------------

    def _cow_attr(self, node: ast.expr) -> Optional[str]:
        """Return the replace-only attr name if ``node`` refers to one."""
        if isinstance(node, ast.Attribute) and (
                node.attr in self.c.cow_replace_only):
            return node.attr
        return None

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            self._check_target(tgt)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_target(node.target)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for tgt in node.targets:
            if isinstance(tgt, ast.Subscript):
                attr = self._cow_attr(tgt.value)
                if attr is not None:
                    self._finding(
                        "cow-mutation", tgt.lineno, f"{attr}|del",
                        f"del on replace-only map {attr}; build a new dict "
                        f"and swap the reference instead")
        self.generic_visit(node)

    def _check_target(self, tgt: ast.expr) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for elt in tgt.elts:
                self._check_target(elt)
            return
        if isinstance(tgt, ast.Subscript):
            attr = self._cow_attr(tgt.value)
            if attr is not None:
                self._finding(
                    "cow-mutation", tgt.lineno, f"{attr}|setitem",
                    f"in-place item assignment on replace-only map {attr}; "
                    f"snapshots alias it — build a new dict and swap")
            return
        if isinstance(tgt, ast.Attribute) and not self._in_constructor():
            owner_fields = self._frozen_owner(tgt.attr)
            if owner_fields is not None:
                self._finding(
                    "frozen-field", tgt.lineno,
                    f"{owner_fields}.{tgt.attr}",
                    f"rebinds replace-only field {tgt.attr} of "
                    f"{owner_fields} after construction; use "
                    f"dataclasses.replace")

    def _frozen_owner(self, attr: str) -> Optional[str]:
        for owner, fields in self.c.frozen_fields.items():
            if attr in fields:
                return owner
        return None

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute):
            if func.attr in _DICT_MUTATORS:
                attr = self._cow_attr(func.value)
                if attr is not None:
                    self._finding(
                        "cow-mutation", node.lineno,
                        f"{attr}|{func.attr}",
                        f".{func.attr}() on replace-only map {attr}; build "
                        f"a new dict and swap the reference instead")
            # object.__setattr__ is the frozen-dataclass bypass — except in
            # a constructor, where it is how frozen __post_init__ normalizes
            # its own fields.
            if (func.attr == "__setattr__"
                    and _dotted(func.value) == "object"
                    and not self._in_constructor()):
                self._finding(
                    "frozen-field", node.lineno, "object.__setattr__",
                    "object.__setattr__ bypasses frozen/replace-only "
                    "discipline; use dataclasses.replace")
        self.generic_visit(node)

    # -- plumbing ----------------------------------------------------------

    def _finding(self, rule: str, line: int, detail: str,
                 message: str) -> None:
        if _suppressed(self.lines, line):
            return
        self.findings.append(
            Finding(rule, self.path, line, self._scope_name(), detail,
                    message))


def check_source(source: str, path: str = "<string>",
                 contracts: Contracts = DEFAULT_CONTRACTS) -> List[Finding]:
    tree = ast.parse(source, filename=path)
    visitor = _CowVisitor(path, source, contracts)
    visitor.visit(tree)
    return visitor.findings


def check_paths(root: Path,
                contracts: Contracts = DEFAULT_CONTRACTS) -> List[Finding]:
    findings: List[Finding] = []
    paths: Sequence[Path]
    if root.is_file():
        paths = [root]
        rel_to = root.parent
    else:
        paths = sorted(root.rglob("*.py"))
        rel_to = root
    for path in paths:
        findings.extend(check_source(
            path.read_text(), path.relative_to(rel_to).as_posix(),
            contracts))
    return findings
