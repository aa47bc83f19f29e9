"""PyTorch port, the concurrency-contract checker and the lockset sanitizer
held against the JAX package's (``tests/test_analysis.py``).

Static side: on every planted fixture of the reference's tests, and on its
clean module, the port's ``lockcheck`` + ``cow`` give the reference's
findings (rule, scope, detail, fingerprint, line, message); the CLI's exit
codes and its baseline ratchet match; the port's own tree is clean against
its committed, empty baseline; ``python -S -m repro_torch.analysis`` runs
with no third-party module loaded.  Every name the port's contracts declare
exists in the port's code, and they differ from the reference's only where
the port's module docstring says so.

Dynamic side: the reference's sanitizer unit tests, mirrored; the port's
module-level kernel ``_load_lock`` checked in the declared order and put
back afterwards; and one deterministic single-thread scenario whose probe
record (every ``access_hook`` call, and ``field_stats()``) is equal in both
packages, so each probe of the port matches a probe of the reference.
"""

import ast
import collections
import os
import pathlib
import subprocess
import sys
import threading
import types
from dataclasses import astuple

import numpy as np
import pytest

import repro.analysis as RAN
import repro.analysis.contracts as RCON
import repro.core.relation as RREL
import repro.core.store as RST
import repro.core.variable_order as RVO
import repro.serve as RSV
import repro_torch.analysis as PAN
import repro_torch.analysis.contracts as PCON
import repro_torch.core.relation as PREL
import repro_torch.core.store as PST
import repro_torch.core.variable_order as PVO
import repro_torch.serve as PSV
import test_analysis as ref_tests
from repro_torch.analysis import cli, cow, lockcheck
from repro_torch.analysis.sanitizer import (
    LockSanitizer,
    SanitizedCondition,
    SanitizedLock,
)
from repro_torch.kernels import _build

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
LOAD_LOCK = "kernels._build._load_lock"

FIXTURES = [*ref_tests.PLANTED, ("clean", ref_tests.FIXTURE_CLEAN)]
FIXTURE_IDS = [f"{i}-{rule}" for i, (rule, _) in enumerate(FIXTURES)]


def _record(findings):
    return [(f.rule, f.path, f.line, f.scope, f.detail, f.message,
             f.fingerprint) for f in findings]


def _findings(an, src):
    return an.lockcheck.check_source(src) + an.cow.check_source(src)


# ---------------------------------------------------------------------------
# static checker: the reference's fixtures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule,src", FIXTURES, ids=FIXTURE_IDS)
def test_fixture_findings_equal_the_reference(rule, src):
    got, want = _findings(PAN, src), _findings(RAN, src)
    assert _record(got) == _record(want)
    if rule == "clean":
        assert got == []
    else:
        assert any(f.rule == rule for f in got), [f.render() for f in got]


def test_suppression_comment_silences_finding():
    src = ref_tests.FIXTURE_UNGUARDED_WRITE.replace(
        "self._relations = {}",
        "self._relations = {}  # lockcheck: test-only suppression")
    assert lockcheck.check_source(src) == []
    untagged = src.replace("lockcheck:", "reason:")
    assert _record(lockcheck.check_source(untagged)) == _record(
        RAN.lockcheck.check_source(untagged))


def test_cow_mutation_flagged_even_under_lock():
    assert not lockcheck.check_source(ref_tests.FIXTURE_COW_MUTATION)
    findings = cow.check_source(ref_tests.FIXTURE_COW_MUTATION)
    assert {f.detail for f in findings} == {"_relations|setitem", "_fds|update"}


def test_fingerprint_is_line_number_stable():
    shifted = "\n\n\n" + ref_tests.FIXTURE_UNGUARDED_WRITE
    a = lockcheck.check_source(ref_tests.FIXTURE_UNGUARDED_WRITE)
    b = lockcheck.check_source(shifted)
    assert [f.fingerprint for f in a] == [f.fingerprint for f in b]
    assert a[0].line != b[0].line


# ---------------------------------------------------------------------------
# the port's own lock: kernels/_build.py's module-level _load_lock
# ---------------------------------------------------------------------------

LOAD_LOCK_NESTING = '''
import threading

_load_lock = threading.Lock()


def function():
    with _load_lock:
        pass


class FactorizedService:
    def cycle(self):
        with self._cycle_lock:
            with _load_lock:  # a first kernel load inside a drain cycle
                pass


class Store:
    def fold(self):
        with self._mutate_lock:
            with _load_lock:  # ... or inside a delta fold
                pass
'''

LOAD_LOCK_INVERSIONS = '''
class FactorizedService:
    def bad(self):
        with _load_lock:
            with self._cycle_lock:
                pass


class ViewCache:
    def bad(self):
        with self._mu:
            with _load_lock:
                pass


def nested():
    with _load_lock:
        with _load_lock:
            pass
'''


def test_bare_load_lock_resolves_to_the_declared_lock():
    tree = ast.parse(LOAD_LOCK_NESTING)
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef))
    checker = lockcheck._FileChecker("<s>", tree, LOAD_LOCK_NESTING,
                                     lockcheck.DEFAULT_CONTRACTS)
    assert checker._resolve_lock_expr(fn.body[0].items[0].context_expr,
                                      None) == LOAD_LOCK
    assert lockcheck.check_source(LOAD_LOCK_NESTING) == []
    # the shipped module takes it in exactly that form
    src = (PORT / "kernels" / "_build.py").read_text()
    assert "with _load_lock:" in src
    checker = lockcheck._FileChecker("_build.py", ast.parse(src), src,
                                     lockcheck.DEFAULT_CONTRACTS)
    assert checker.run() == [] and LOAD_LOCK in checker.acquired


def test_load_lock_inversions_are_findings():
    got = {(f.rule, f.scope, f.detail)
           for f in lockcheck.check_source(LOAD_LOCK_INVERSIONS)}
    assert got == {
        ("lock-order", "FactorizedService.bad",
         f"{LOAD_LOCK}->FactorizedService._cycle_lock"),
        ("lock-order", "ViewCache.bad", f"ViewCache._mu->{LOAD_LOCK}"),
        ("self-deadlock", "nested", LOAD_LOCK),
    }


# ---------------------------------------------------------------------------
# CLI + ratchet baseline
# ---------------------------------------------------------------------------

def _write(tmp_path, name, src):
    p = tmp_path / name
    p.write_text(src)
    return p


@pytest.mark.parametrize("rule,src", FIXTURES, ids=FIXTURE_IDS)
def test_cli_exit_code_equals_the_reference(tmp_path, rule, src):
    p = _write(tmp_path, "fixture.py", src)
    want = RAN.cli.main([str(p)])
    assert want == (0 if rule == "clean" else 1)
    assert cli.main([str(p)]) == want


def test_cli_exits_zero_on_port_with_committed_baseline():
    baseline = REPO / "analysis_baseline_torch.json"
    assert cli.load_baseline(baseline) == set()  # nothing is ratcheted
    assert cli.main(["--baseline", str(baseline)]) == 0  # default root
    assert cli._default_root() == PORT
    assert cli.collect([PORT]) == []


def test_baseline_ratchet_old_passes_new_fails(tmp_path):
    fixtures = tmp_path / "pkg"
    fixtures.mkdir()
    _write(fixtures, "legacy.py", ref_tests.FIXTURE_UNGUARDED_WRITE)
    baseline = tmp_path / "baseline.json"
    ref_baseline = tmp_path / "ref_baseline.json"
    assert cli.main([str(fixtures), "--write-baseline", str(baseline)]) == 0
    assert RAN.cli.main([str(fixtures), "--write-baseline",
                         str(ref_baseline)]) == 0
    assert baseline.read_text() == ref_baseline.read_text()
    assert cli.main([str(fixtures), "--baseline", str(baseline)]) == 0
    _write(fixtures, "fresh.py", ref_tests.FIXTURE_COW_MUTATION)
    assert cli.main([str(fixtures), "--baseline", str(baseline)]) == 1
    (fixtures / "fresh.py").unlink()
    assert cli.main([str(fixtures), "--baseline", str(baseline)]) == 0
    assert cli.main([str(tmp_path / "missing")]) == 2
    assert cli.main([str(fixtures), "--baseline",
                     str(tmp_path / "missing.json")]) == 2


def test_checker_runs_bare_with_no_third_party_module():
    """``python -S`` (no site-packages): the CLI exits 0 on the port and
    loads no torch, numpy, jax or repro."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    env.pop("PYTHONSTARTUP", None)
    cmd = [sys.executable, "-S", "-m", "repro_torch.analysis",
           "--baseline", "analysis_baseline_torch.json"]
    run = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "analysis clean: 0 finding(s)" in run.stdout
    probe = (
        "import sys\n"
        "from repro_torch.analysis import cli, sanitizer\n"
        "rc = cli.main(['--baseline', 'analysis_baseline_torch.json'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "{'torch', 'numpy', 'jax', 'repro'})\n"
        "print('LOADED', bad)\n"
        "sys.exit(rc)\n"
    )
    run = subprocess.run([sys.executable, "-S", "-c", probe], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "LOADED []" in run.stdout


# ---------------------------------------------------------------------------
# the port's contracts: every name exists, differences from the reference
# ---------------------------------------------------------------------------

def _port_classes():
    """class name -> (attributes it sets or declares, methods), over the
    port's tree, by ``ast``."""
    out = collections.defaultdict(lambda: (set(), set()))
    for path in sorted(PORT.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.ClassDef):
                continue
            attrs, meths = out[node.name]
            for ch in node.body:
                if isinstance(ch, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    meths.add(ch.name)
                elif isinstance(ch, ast.AnnAssign):
                    attrs.add(ch.target.id)
            for sub in ast.walk(node):
                if (isinstance(sub, ast.Attribute)
                        and isinstance(sub.ctx, ast.Store)
                        and isinstance(sub.value, ast.Name)
                        and sub.value.id == "self"):
                    attrs.add(sub.attr)
    return out


def _module_names(dotted):
    path = PORT.joinpath(*dotted.split(".")).with_suffix(".py")
    tree = ast.parse(path.read_text())
    return {t.id for n in tree.body if isinstance(n, ast.Assign)
            for t in n.targets if isinstance(t, ast.Name)}


def _contract_names(table):
    """(owner, name, kind) triples a contract table declares."""
    c = PCON
    if table == "locks":
        return [(s.owner, s.attr, "attr") for s in c.LOCKS]
    if table == "conditions":
        return [(*k.split("."), "attr") for k in c.CONDITIONS]
    if table == "guards":
        return [(o, g.attr, "attr") for g in c.GUARDS for o in g.owners]
    if table in ("entry_held", "method_acquires", "snapshot_scopes"):
        names = {"entry_held": c.ENTRY_HELD,
                 "method_acquires": c.METHOD_ACQUIRES,
                 "snapshot_scopes": c.SNAPSHOT_SCOPES}[table]
        return [(*k.split("."), "method") for k in names]
    if table == "frozen_fields":
        return [(o, f, "attr") for o, fs in c.FROZEN_FIELDS.items()
                for f in fs]
    return [("Store", a, "attr") for a in c.COW_REPLACE_ONLY]


@pytest.mark.parametrize("table", [
    "locks", "conditions", "guards", "entry_held", "method_acquires",
    "snapshot_scopes", "frozen_fields", "cow_replace_only",
])
def test_every_declared_name_exists_in_the_port(table):
    classes = _port_classes()
    missing = []
    for owner, name, kind in _contract_names(table):
        if owner.startswith("kernels."):  # a module-level lock
            ok = name in _module_names(owner)
        else:
            attrs, meths = classes.get(owner, (set(), set()))
            ok = name in (meths if kind == "method" else attrs)
        if not ok:
            missing.append(f"{owner}.{name}")
    assert missing == []


def test_contracts_differ_from_the_reference_only_as_documented():
    assert [astuple(s) for s in PCON.LOCKS[:-1]] == [
        astuple(s) for s in RCON.LOCKS]
    assert PCON.LOCKS[-1].name == LOAD_LOCK
    assert not PCON.LOCKS[-1].reentrant
    order = {k: tuple(x for x in v if x != LOAD_LOCK)
             for k, v in PCON.ORDER.items() if k != LOAD_LOCK}
    assert order == RCON.ORDER and PCON.ORDER[LOAD_LOCK] == ()
    nest = {k for k, v in PCON.ORDER.items() if LOAD_LOCK in v}
    assert nest == {"FactorizedService._cycle_lock", "Store._mutate_lock"}
    closure = PCON.DEFAULT_CONTRACTS.closure()
    assert LOAD_LOCK not in closure["ViewCache._mu"]
    guards = {g.attr: g for g in PCON.GUARDS}
    ref_guards = {g.attr: g for g in RCON.GUARDS}
    assert set(guards) == set(ref_guards)
    for attr, g in guards.items():
        want = astuple(ref_guards[attr])
        if attr == "_fds":
            assert want[3] == ("Store", "StoreSnapshot")
            assert g.owners == ("Store",)
            want = want[:3] + (g.owners,) + want[4:]
        assert astuple(g) == want
    renamed = {"ViewCache.invalidate": "ViewCache.invalidate_relation",
               "ViewCache.delta_update": "ViewCache.replace"}
    assert PCON.METHOD_ACQUIRES == {
        renamed.get(k, k): v for k, v in RCON.METHOD_ACQUIRES.items()}
    for name in ("CONDITIONS", "ENTRY_HELD", "RECEIVER_CLASS_HINTS",
                 "COW_REPLACE_ONLY", "FROZEN_FIELDS", "MUTATOR_METHODS",
                 "CONSTRUCTOR_SCOPES", "SNAPSHOT_SCOPES", "SUPPRESS_TAG"):
        assert getattr(PCON, name) == getattr(RCON, name), name


# ---------------------------------------------------------------------------
# dynamic sanitizer (standalone: real threads, wrapped locks)
# ---------------------------------------------------------------------------

def _locks(san):
    a = SanitizedLock(san, "Store._mutate_lock", threading.RLock())
    b = SanitizedLock(san, "ViewCache._mu", threading.RLock())
    return a, b


def test_sanitizer_reports_empty_lockset_interleaving():
    san = LockSanitizer()
    lock_a, lock_b = _locks(san)
    field = "FactorizedService._seq"  # declared policy: full
    first_done = threading.Event()
    second_done = threading.Event()

    def first():
        with lock_a:
            san._access(field, "write")
        first_done.set()
        second_done.wait(5)  # alive until the second access: no ident reuse

    def second():
        first_done.wait(5)
        with lock_b:
            san._access(field, "write")
        second_done.set()

    t1 = threading.Thread(target=first)
    t2 = threading.Thread(target=second)
    t1.start(); t2.start()
    t2.join(); t1.join()
    assert [r.field for r in san.empty_locksets] == [field]
    with pytest.raises(AssertionError):
        san.assert_clean()


def test_sanitizer_consistent_lock_keeps_lockset():
    san = LockSanitizer()
    lock_a, _ = _locks(san)
    field = "FactorizedService._seq"

    def worker():
        with lock_a:
            san._access(field, "write")

    for _ in range(2):
        t = threading.Thread(target=worker)
        t.start(); t.join()
    assert san.empty_locksets == []
    san.assert_clean()


def test_sanitizer_memo_policy_fields_are_exempt():
    san = LockSanitizer()

    def worker():
        san._access("Store._enc_cols", "write")  # memo: no lock at all

    for _ in range(2):
        t = threading.Thread(target=worker)
        t.start(); t.join()
    san.assert_clean()


def test_sanitizer_runtime_order_assertion():
    san = LockSanitizer()
    mutate, vc_mu = _locks(san)
    with vc_mu:
        with mutate:  # ViewCache._mu then Store._mutate_lock: inversion
            pass
    assert len(san.order_violations) == 1
    v = san.order_violations[0]
    assert v.acquired == "Store._mutate_lock" and "ViewCache._mu" in v.held


def test_sanitizer_allows_declared_nesting_and_reentrancy():
    san = LockSanitizer()
    mutate, vc_mu = _locks(san)
    with mutate:
        with mutate:
            with vc_mu:
                pass
    san.assert_clean()
    assert san.acquisitions["Store._mutate_lock"] == 2


def test_sanitized_condition_flags_wait_while_holding():
    san = LockSanitizer()
    cycle = SanitizedLock(san, "FactorizedService._cycle_lock",
                          threading.RLock())
    queue = SanitizedLock(san, "FactorizedService._lock", threading.Lock())
    cond = SanitizedCondition(san, "FactorizedService._not_full", queue)
    with cycle:
        with cond:
            cond.wait(timeout=0.01)  # cycle lock still held -> violation
    assert len(san.wait_violations) == 1
    assert san.wait_violations[0].held == ("FactorizedService._cycle_lock",)

    san2 = LockSanitizer()
    queue2 = SanitizedLock(san2, "FactorizedService._lock", threading.Lock())
    cond2 = SanitizedCondition(san2, "FactorizedService._not_full", queue2)
    with cond2:
        cond2.wait(timeout=0.01)
    san2.assert_clean()


def test_sanitized_condition_notify_roundtrip():
    san = LockSanitizer()
    queue = SanitizedLock(san, "FactorizedService._lock", threading.Lock())
    cond = SanitizedCondition(san, "FactorizedService._not_full", queue)
    ready = []

    def waiter():
        with cond:
            while not ready:
                cond.wait(timeout=1.0)

    t = threading.Thread(target=waiter)
    t.start()
    with cond:
        ready.append(1)
        cond.notify_all()
    t.join(timeout=5)
    assert not t.is_alive()
    san.assert_clean()
    assert san._held.stack == []


# ---------------------------------------------------------------------------
# the kernels' load lock under the sanitizer
# ---------------------------------------------------------------------------

def _fake_first_load(monkeypatch, tmp_path):
    """``_build.function`` with nvcc and ctypes faked out, as in
    ``test_torch_kernels.py::test_first_load_builds_and_loads_once_across_threads``."""
    import ctypes

    lib_path = tmp_path / "segment_view-x.so"
    calls = {"build": 0, "load": 0}

    def build():
        calls["build"] += 1
        lib_path.write_bytes(b"")

    class Lib:
        def __init__(self, path):
            calls["load"] += 1
            self.sym = types.SimpleNamespace(argtypes=None, restype=None)

    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "library_path", lambda name: lib_path)
    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(ctypes, "CDLL", Lib)
    return calls, lambda: _build.function("segment_view", "sym",
                                          [ctypes.c_int])


def test_first_load_under_cycle_lock_is_in_order(monkeypatch, tmp_path):
    original = _build._load_lock
    monkeypatch.setattr(_build, "_load_lock", original)  # restored anyway
    calls, load = _fake_first_load(monkeypatch, tmp_path)
    san = LockSanitizer()
    cycle = SanitizedLock(san, "FactorizedService._cycle_lock",
                          threading.RLock())
    mutate = SanitizedLock(san, "Store._mutate_lock", threading.RLock())
    san.install(load_lock=True)
    try:
        assert isinstance(_build._load_lock, SanitizedLock)

        def drain_worker():  # the first kernel use inside a drain cycle
            with cycle:
                with mutate:
                    load()

        t = threading.Thread(target=drain_worker)
        t.start()
        t.join(10)
        assert not t.is_alive()
        load()  # loaded: the second call takes no lock
    finally:
        san.uninstall()
    assert _build._load_lock is original  # put back
    assert calls == {"build": 1, "load": 1}
    assert san.acquisitions[LOAD_LOCK] == 1
    san.assert_clean()


def test_cycle_lock_under_load_lock_is_a_violation(monkeypatch):
    original = _build._load_lock
    monkeypatch.setattr(_build, "_load_lock", original)
    san = LockSanitizer().install(load_lock=True)
    try:
        cycle = SanitizedLock(san, "FactorizedService._cycle_lock",
                              threading.RLock())
        with _build._load_lock:
            with cycle:
                pass
    finally:
        san.uninstall()
    assert _build._load_lock is original
    assert len(san.order_violations) == 1
    v = san.order_violations[0]
    assert v.acquired == "FactorizedService._cycle_lock"
    assert v.held == (LOAD_LOCK,)
    san.uninstall()  # a second uninstall is a no-op
    assert _build._load_lock is original


# ---------------------------------------------------------------------------
# probe parity: one deterministic single-thread scenario, both packages
# ---------------------------------------------------------------------------

def _probe_pkg(ref):
    rel, st, vo, sv, an = ((RREL, RST, RVO, RSV, RAN) if ref
                           else (PREL, PST, PVO, PSV, PAN))
    return types.SimpleNamespace(
        Relation=rel.Relation, Store=st.Store, VariableOrder=vo.VariableOrder,
        Service=sv.FactorizedService, LockSanitizer=an.LockSanitizer,
        svc={} if ref else {"backend": "numpy"},
    )


def _probe_relations(m, seed=3, n=60, dom=5):
    rng = np.random.default_rng(seed)
    fact = m.Relation.from_columns(
        "Fact",
        {"c0": rng.integers(0, dom, n).astype(np.int32),
         "c1": rng.integers(0, dom, n).astype(np.int32)},
        {"x": rng.normal(0, 2.0, n), "y": rng.normal(0, 1.0, n)},
        {"c0": dom, "c1": dom},
    )
    c = np.arange(dom, dtype=np.int32)
    dim = m.Relation.from_columns(
        "Dim0", {"c0": c, "d0": (c % 2).astype(np.int32)},
        {"w0": rng.normal(0, 1.0, dom)}, {"c0": dom, "d0": 2},
    )
    return fact, dim


def _probe_scenario(m):
    """Every public path that reaches a probe, on one thread; returns the
    raw probe record (every hook call, in order) and ``field_stats()``."""
    VO = m.VariableOrder
    vorder = VO.intercept([VO("c0", [
        VO("d0", [VO("w0", [VO.leaf("Dim0")])]),
        VO("c1", [VO("x", [VO("y", [VO.leaf("Fact")])])]),
    ])])
    fact, dim = _probe_relations(m)
    store = m.Store([fact, dim])
    svc = m.Service(store, **m.svc)
    san = m.LockSanitizer()
    calls = []

    def hook(field, kind):
        calls.append((field, kind))
        san._access(field, kind)

    def attach():
        store.access_hook = store.view_cache.access_hook = hook
        svc.access_hook = hook

    attach()  # install() encodes every attribute: record those probes too
    san.install(service=svc)
    attach()
    store.add_fd("c0", "d0")
    store.column_moments("x")
    store.attr_encoding("Fact", "c1")
    store.cofactors(vorder, ["x", "y"], backend="numpy")
    store.cat_cofactors(vorder, ["x", "y"], ["c1", "d0"], backend="numpy",
                        reduce_fds=True)
    delta = _probe_relations(m, seed=4, n=7)[0]
    store.append("Fact", delta)
    store.flush()
    store.cofactors(vorder, ["x", "y"], backend="numpy")
    snap = store.snapshot()
    snap.column_moments("y")
    snap.attr_encoding("Fact", "c0")
    store.drop_fd("c0", "d0")
    store.put(_probe_relations(m, seed=5)[1])
    store.attr_encoding("Dim0", "d0")  # a miss after the put: a memo fill
    t1 = svc.cofactors("a", vorder, ["x", "y"])
    t2 = svc.append("b", "Fact", delta)
    t3 = svc.train("a", vorder, ["x"], "y")
    svc.run()
    for t in (t1, t2, t3):
        t.result()
    svc.flush()
    store.cache_info()
    svc.cache_info()
    san.assert_clean()
    return collections.Counter(calls), san.field_stats()


def test_probes_match_the_reference_one_for_one():
    got_calls, got_stats = _probe_scenario(_probe_pkg(False))
    want_calls, want_stats = _probe_scenario(_probe_pkg(True))
    assert got_calls == want_calls
    assert got_stats == want_stats
    fields = {f for f, _ in got_calls}
    for field in ("Store._enc_cols", "Store._vorders", "Store._relations",
                  "Store._fds", "Store._red_cache", "Store._delta_log",
                  "Store._moments", "Store._cofactor_cache",
                  "Store._cat_cache", "ViewCache._entries",
                  "FactorizedService._reads", "FactorizedService._writes",
                  "FactorizedService._seq", "FactorizedService._tenants",
                  "FactorizedService._snapshot"):
        assert field in fields, field


def test_probes_are_no_ops_without_a_hook():
    m = _probe_pkg(False)
    store = m.Store(list(_probe_relations(m)))
    assert store.access_hook is None and store.view_cache.access_hook is None
    store._access("Store._relations", "write")
    store.view_cache._access("ViewCache._entries", "read")
