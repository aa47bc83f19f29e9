"""Static lock-order and guarded-by checker for ``src/repro_torch``.

A stdlib-``ast`` pass (no third-party imports — runs in a bare-Python CI
job) that, per file:

1. **Lock-acquisition graph.**  Every acquisition site — ``with self._lock``
   blocks (including ``Condition`` context managers), the ``@_locked``
   decorator, and calls to methods declared in
   ``contracts.METHOD_ACQUIRES`` — is folded into a directed graph of
   *observed* nesting edges ``held -> acquired``.  The graph is checked
   against the declared partial order (``contracts.ORDER``): edges outside
   the transitive closure are ``lock-order`` findings, cycles in the
   observed graph are ``lock-cycle`` findings, and re-acquisition of a
   non-reentrant lock is a ``self-deadlock`` finding.

2. **Condition discipline.**  ``cond.wait()`` while holding any lock other
   than the condition's own base lock is a ``condition-wait`` finding
   (waiting releases only the base lock; everything else stays wedged).
   ``notify``/``notify_all`` without the base lock held is a
   ``condition-notify`` finding.

3. **Guarded-by enforcement.**  Attribute accesses against the declared
   guard map (``contracts.GUARDS``): writes (and, under the ``"full"``
   policy, reads) of a guarded attribute outside a region holding its lock
   are ``guarded-by`` findings.  Constructors, declared snapshot scopes and
   ``# lockcheck: <reason>`` suppression comments are exempt.

The pass is intraprocedural with two contract-driven extensions: functions
in ``contracts.ENTRY_HELD`` are analyzed with their declared locks held, and
calls to known acquiring methods contribute graph edges (receiver resolved
via ``self``/class context or ``contracts.RECEIVER_CLASS_HINTS``).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .contracts import SUPPRESS_TAG, Contracts, DEFAULT_CONTRACTS


# --------------------------------------------------------------------------
# Findings
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Finding:
    """One checker finding.

    The fingerprint deliberately omits the line number so unrelated edits in
    the same file don't churn the ratchet baseline — a finding is identified
    by (rule, file, enclosing scope, detail).
    """

    rule: str
    path: str
    line: int
    scope: str
    detail: str
    message: str

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}|{self.path}|{self.scope}|{self.detail}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}: [{self.rule}] {self.scope}: "
                f"{self.message}")


# --------------------------------------------------------------------------
# Helpers
# --------------------------------------------------------------------------


def _dotted(node: ast.AST) -> Optional[str]:
    """Render ``a.b.c`` attribute/name chains; None for anything else."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        if base is None:
            return None
        return f"{base}.{node.attr}"
    return None


def _suppressed(lines: Sequence[str], lineno: int) -> bool:
    """True if the source line (or the one above) carries the suppress tag."""
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(lines) and SUPPRESS_TAG in lines[ln - 1]:
            return True
    return False


@dataclass
class _Access:
    attr: str
    kind: str  # "read" | "write"
    line: int


class _FileChecker:
    """Runs all checks over one parsed module."""

    def __init__(self, path: str, tree: ast.Module, source: str,
                 contracts: Contracts) -> None:
        self.path = path
        self.tree = tree
        self.lines = source.splitlines()
        self.c = contracts
        self.closure = contracts.closure()
        self.lock_attrs = contracts.lock_by_attr()
        self.guards = contracts.guards_by_attr()
        self.findings: List[Finding] = []
        #: observed nesting edges: (held, acquired) -> first line seen
        self.edges: Dict[Tuple[str, str], Tuple[int, str]] = {}
        #: acquisitions with nothing held (graph nodes)
        self.acquired: Set[str] = set()

    # -- entry point -------------------------------------------------------

    def run(self) -> List[Finding]:
        for node in self.tree.body:
            self._visit_toplevel(node, cls=None)
        self._check_graph()
        return self.findings

    def _visit_toplevel(self, node: ast.AST, cls: Optional[str]) -> None:
        if isinstance(node, ast.ClassDef):
            for child in node.body:
                self._visit_toplevel(child, cls=node.name)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._check_function(node, cls)
        # module-level statements outside functions rarely touch locks; the
        # guarded attrs are instance state, so nothing to do here.

    # -- per-function analysis --------------------------------------------

    def _qualname(self, cls: Optional[str], func: str) -> str:
        return f"{cls}.{func}" if cls else func

    def _check_function(self, fn: ast.FunctionDef, cls: Optional[str]) -> None:
        qual = self._qualname(cls, fn.name)
        held: List[str] = list(self.c.entry_held.get(qual, ()))
        for deco in fn.decorator_list:
            name = _dotted(deco)
            if name and name.split(".")[-1] == "_locked":
                # The _locked decorator wraps the body in the owner's mutate
                # lock; the decorator itself acquires with nothing held.
                self.acquired.add("Store._mutate_lock")
                held.append("Store._mutate_lock")
        self._walk_body(fn.body, held, cls, qual)
        # nested defs are visited by _walk_body with a fresh held stack

    def _walk_body(self, body: Sequence[ast.stmt], held: List[str],
                   cls: Optional[str], scope: str) -> None:
        for stmt in body:
            self._walk_stmt(stmt, held, cls, scope)

    def _walk_stmt(self, stmt: ast.stmt, held: List[str],
                   cls: Optional[str], scope: str) -> None:
        if isinstance(stmt, ast.With):
            locks_here: List[str] = []
            for item in stmt.items:
                lock = self._resolve_lock_expr(item.context_expr, cls)
                if lock is not None:
                    self._note_acquire(lock, held + locks_here,
                                       stmt.lineno, scope)
                    locks_here.append(lock)
                else:
                    self._scan_expr(item.context_expr, held, cls, scope)
            self._walk_body(stmt.body, held + locks_here, cls, scope)
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # Nested function: runs later, with an unknown held set.  Analyze
            # with an empty stack unless it has its own entry contract.
            self._check_function(stmt, cls)
            return
        if isinstance(stmt, ast.ClassDef):
            self._visit_toplevel(stmt, cls=stmt.name)
            return
        # Generic statement: scan expressions, then recurse into blocks.
        for expr in ast.iter_child_nodes(stmt):
            if isinstance(expr, ast.expr):
                self._scan_expr(expr, held, cls, scope)
        self._scan_targets(stmt, held, cls, scope)
        for attr in ("body", "orelse", "finalbody"):
            block = getattr(stmt, attr, None)
            if block:
                self._walk_body(block, held, cls, scope)
        for handler in getattr(stmt, "handlers", ()) or ():
            self._walk_body(handler.body, held, cls, scope)
        for case in getattr(stmt, "cases", ()) or ():
            self._walk_body(case.body, held, cls, scope)

    # -- lock resolution ---------------------------------------------------

    def _resolve_lock_expr(self, expr: ast.expr,
                           cls: Optional[str]) -> Optional[str]:
        """Map a with-item context expression to a canonical lock name."""
        dotted = _dotted(expr)
        if dotted is None:
            return None
        attr = dotted.split(".")[-1]
        # Condition variables count as their base lock.
        for cond, base in self.c.conditions.items():
            if attr == cond.split(".")[-1]:
                return base
        specs = self.lock_attrs.get(attr)
        if not specs:
            return None
        if dotted == f"self.{attr}" and cls is not None:
            # `with self.<attr>` in a class that is not a declared owner is
            # some other class's lock of the same name — not ours to check.
            for spec in specs:
                if spec.owner == cls:
                    return spec.name
            return None
        if len(specs) == 1:
            return specs[0].name
        # Ambiguous attr on a non-self receiver: try receiver hints.
        owner = self._resolve_receiver_class(
            expr.value if isinstance(expr, ast.Attribute) else expr, cls)
        for spec in specs:
            if spec.owner == owner:
                return spec.name
        return specs[0].name

    def _note_acquire(self, lock: str, held: Sequence[str], line: int,
                      scope: str) -> None:
        self.acquired.add(lock)
        for h in reversed(held):
            if h == lock:
                if not self.c.reentrant(lock):
                    self._finding(
                        "self-deadlock", line, scope, lock,
                        f"re-acquires non-reentrant {lock} while already "
                        f"holding it (guaranteed deadlock)")
                # Reentrant self-edge carries no ordering information.
                continue
            key = (h, lock)
            if key not in self.edges:
                self.edges[key] = (line, scope)
            if lock not in self.closure.get(h, frozenset()):
                self._finding(
                    "lock-order", line, scope, f"{h}->{lock}",
                    f"acquires {lock} while holding {h}, which the declared "
                    f"hierarchy does not allow")

    # -- expression scanning ----------------------------------------------

    def _scan_targets(self, stmt: ast.stmt, held: List[str],
                      cls: Optional[str], scope: str) -> None:
        """Classify assignment/del targets as writes."""
        targets: List[ast.expr] = []
        if isinstance(stmt, ast.Assign):
            targets = list(stmt.targets)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            targets = [stmt.target]
        elif isinstance(stmt, ast.Delete):
            targets = list(stmt.targets)
        for tgt in targets:
            self._scan_write_target(tgt, held, cls, scope)

    def _scan_write_target(self, tgt: ast.expr, held: List[str],
                           cls: Optional[str], scope: str) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for elt in tgt.elts:
                self._scan_write_target(elt, held, cls, scope)
            return
        if isinstance(tgt, ast.Attribute):
            self._check_guarded(tgt.attr, "write", tgt, held, cls, scope)
        elif isinstance(tgt, ast.Subscript):
            # d[k] = v / del d[k] on a guarded attribute is an in-place write
            if isinstance(tgt.value, ast.Attribute):
                self._check_guarded(tgt.value.attr, "write", tgt.value,
                                    held, cls, scope)

    def _scan_expr(self, expr: ast.expr, held: List[str],
                   cls: Optional[str], scope: str) -> None:
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                self._scan_call(node, held, cls, scope)
            elif isinstance(node, ast.Attribute):
                if isinstance(node.ctx, (ast.Store, ast.Del)):
                    self._check_guarded(node.attr, "write", node, held, cls,
                                        scope)
                elif isinstance(node.ctx, ast.Load):
                    self._check_guarded(node.attr, "read", node, held, cls,
                                        scope)

    def _scan_call(self, call: ast.Call, held: List[str],
                   cls: Optional[str], scope: str) -> None:
        func = call.func
        if not isinstance(func, ast.Attribute):
            return
        meth = func.attr
        recv = func.value
        # cond.wait(...) / cond.notify_all(...)
        if isinstance(recv, ast.Attribute) or isinstance(recv, ast.Name):
            recv_dotted = _dotted(recv)
        else:
            recv_dotted = None
        if recv_dotted is not None:
            recv_attr = recv_dotted.split(".")[-1]
            for cond, base in self.c.conditions.items():
                if recv_attr != cond.split(".")[-1]:
                    continue
                if meth in ("wait", "wait_for"):
                    others = [h for h in held if h != base]
                    if others:
                        self._finding(
                            "condition-wait", call.lineno, scope,
                            f"{cond}|{','.join(sorted(set(others)))}",
                            f"waits on {cond} while holding "
                            f"{', '.join(sorted(set(others)))}; wait() "
                            f"releases only {base}")
                    if base not in held:
                        self._finding(
                            "condition-wait", call.lineno, scope,
                            f"{cond}|unheld",
                            f"waits on {cond} without holding {base}")
                elif meth in ("notify", "notify_all"):
                    if base not in held:
                        self._finding(
                            "condition-notify", call.lineno, scope,
                            f"{cond}|{meth}",
                            f"calls {meth}() on {cond} without holding "
                            f"{base}")
        # Mutator-method call on a guarded attribute: x._reads.append(...)
        if meth in _MUTATORS and isinstance(recv, ast.Attribute):
            self._check_guarded(recv.attr, "write", recv, held, cls, scope)
        # Call-edge inference: known acquiring methods.
        owner = self._resolve_receiver_class(recv, cls)
        if owner is not None:
            acquired = self.c.method_acquires.get(f"{owner}.{meth}")
            if acquired:
                for lock in acquired:
                    self._note_acquire(lock, held, call.lineno, scope)

    def _resolve_receiver_class(self, recv: ast.expr,
                                cls: Optional[str]) -> Optional[str]:
        dotted = _dotted(recv)
        if dotted is None:
            return None
        if dotted == "self":
            return cls
        hint = self.c.receiver_hints.get(dotted)
        if hint is not None:
            return hint
        # `self.<x>` with an unhinted tail: try the tail alone.
        tail = dotted.split(".")[-1]
        return self.c.receiver_hints.get(tail)

    # -- guarded-by --------------------------------------------------------

    def _check_guarded(self, attr: str, kind: str, node: ast.expr,
                       held: List[str], cls: Optional[str],
                       scope: str) -> None:
        spec = self.guards.get(attr)
        if spec is None:
            return
        # Receiver scoping: `self.<attr>` only counts when the enclosing
        # class is a declared owner; non-self receivers match by name (the
        # guarded attribute names are project-unique).
        if isinstance(node, ast.Attribute):
            recv = _dotted(node.value)
            if recv == "self" and cls is not None and cls not in spec.owners:
                return
        if spec.policy in ("write", "memo") and kind == "read":
            return
        if spec.lock in held:
            return
        func_name = scope.split(".")[-1]
        if func_name in self.c.constructor_scopes:
            return
        if scope in self.c.snapshot_scopes:
            return
        if _suppressed(self.lines, node.lineno):
            return
        need = ("write" if kind == "write" else "read")
        self._finding(
            "guarded-by", node.lineno, scope, f"{attr}|{kind}",
            f"{need} of {attr} (guarded by {spec.lock}, policy "
            f"{spec.policy}) outside the lock")

    # -- graph-level checks ------------------------------------------------

    def _check_graph(self) -> None:
        """Cycle detection over the observed acquisition graph."""
        adj: Dict[str, Set[str]] = {}
        for (a, b) in self.edges:
            if a == b:
                continue
            adj.setdefault(a, set()).add(b)
        # Iterative DFS with colors.
        WHITE, GRAY, BLACK = 0, 1, 2
        color = {n: WHITE for n in set(adj) | {b for s in adj.values()
                                              for b in s}}
        for root in sorted(color):
            if color[root] != WHITE:
                continue
            stack: List[Tuple[str, List[str]]] = [(root, [root])]
            while stack:
                node, path = stack.pop()
                if node == "__pop__":
                    color[path[-1]] = BLACK
                    continue
                if color[node] == BLACK:
                    continue
                color[node] = GRAY
                stack.append(("__pop__", [node]))
                for nxt in sorted(adj.get(node, ())):
                    if color[nxt] == GRAY and nxt in path:
                        cyc = path[path.index(nxt):] + [nxt]
                        line, scope = self.edges.get((node, nxt), (0, ""))
                        self._finding(
                            "lock-cycle", line, scope or "<module>",
                            "->".join(cyc),
                            f"observed acquisition cycle "
                            f"{' -> '.join(cyc)}")
                    elif color[nxt] == WHITE:
                        stack.append((nxt, path + [nxt]))

    # -- plumbing ----------------------------------------------------------

    def _finding(self, rule: str, line: int, scope: str, detail: str,
                 message: str) -> None:
        if _suppressed(self.lines, line):
            return
        self.findings.append(Finding(rule, self.path, line, scope, detail,
                                     message))


_MUTATORS = frozenset({
    "append", "appendleft", "extend", "extendleft", "insert", "remove",
    "pop", "popleft", "popitem", "clear", "update", "setdefault",
    "add", "discard", "record", "sort",
})


# --------------------------------------------------------------------------
# Public API
# --------------------------------------------------------------------------


def check_source(source: str, path: str = "<string>",
                 contracts: Contracts = DEFAULT_CONTRACTS) -> List[Finding]:
    tree = ast.parse(source, filename=path)
    findings = _FileChecker(path, tree, source, contracts).run()
    # The walker can classify one access through two paths (expression scan
    # + assignment-target scan); collapse exact duplicates.
    seen: Set[Tuple[str, int]] = set()
    out: List[Finding] = []
    for f in findings:
        key = (f.fingerprint, f.line)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


def check_file(file_path: Path, rel_to: Optional[Path] = None,
               contracts: Contracts = DEFAULT_CONTRACTS) -> List[Finding]:
    source = file_path.read_text()
    rel = (file_path.relative_to(rel_to) if rel_to is not None
           else file_path)
    return check_source(source, rel.as_posix(), contracts)


def check_paths(root: Path,
                contracts: Contracts = DEFAULT_CONTRACTS) -> List[Finding]:
    """Check a file or every ``*.py`` under a directory (sorted, stable)."""
    findings: List[Finding] = []
    if root.is_file():
        return check_file(root, root.parent, contracts)
    for path in sorted(root.rglob("*.py")):
        findings.extend(check_file(path, root, contracts))
    return findings
