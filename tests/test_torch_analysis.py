"""The port's invariant tools (``repro_torch.analysis``) held against the
reference's (``repro.analysis``) on the same inputs.

Every case feeds one input to both tools and requires the same outcome:
the fixture trees of ``tests/test_analysis.py`` rule by rule, the
suppressions, the baseline round trip, the CLI (exit codes, text, JSON and
SARIF reports, ``--list-rules``), both source trees, the wire-doc-drift
cases, the wire table and its generator, the model checker (baseline and
every seeded mutant), the spec-drift cases of ``tests/test_protocol_spec.py``
applied to the port's spec, the lock-order sanitizer's cases of
``tests/test_analysis.py`` under each sanitizer, and the fuzzer.  Messages
are compared with the package name folded (``repro_torch.`` to ``repro.``):
a finding's hint names its own tool's module.
"""
import dataclasses
import json
import shutil
import threading
from pathlib import Path
from types import SimpleNamespace

import pytest
from test_analysis import BAD, GOOD

import repro.analysis.__main__ as r_main
import repro.analysis.protocol.__main__ as r_proto_main
import repro_torch.analysis.__main__ as t_main
import repro_torch.analysis.protocol.__main__ as t_proto_main
from repro.analysis import core as r_core
from repro.analysis import lockorder as r_lockorder
from repro.analysis.protocol import model as r_model
from repro.analysis.protocol import spec as r_spec
from repro.configs import get_dlrm_config as r_get_dlrm_config
from repro_torch.analysis import core as t_core
from repro_torch.analysis import lockorder as t_lockorder
from repro_torch.analysis.protocol import model as t_model
from repro_torch.analysis.protocol import spec as t_spec
from repro_torch.configs import get_dlrm_config as t_get_dlrm_config

ROOT = Path(__file__).resolve().parents[1]
TOOLS = {
    "reference": SimpleNamespace(core=r_core, cli=r_main.main,
                                 proto_cli=r_proto_main.main,
                                 lockorder=r_lockorder, model=r_model,
                                 spec=r_spec, package="repro"),
    "port": SimpleNamespace(core=t_core, cli=t_main.main,
                            proto_cli=t_proto_main.main,
                            lockorder=t_lockorder, model=t_model,
                            spec=t_spec, package="repro_torch")}
RULES = ("durability-ordering", "epoch-threading", "exception-hygiene",
         "lock-discipline", "protocol-conformance", "time-source",
         "wire-doc-drift")


def _fold(text):
    return text.replace("repro_torch.", "repro.")


def _findings(report):
    return [(f.rule, f.path, f.line, _fold(f.message), f.suppressed,
             f.suppress_reason, f.baselined) for f in report.findings]


def _both(**kw):
    """Both tools' reports on the same input, required equal."""
    out = {name: tool.core.run_analysis(**kw) for name, tool in TOOLS.items()}
    ref, port = out["reference"], out["port"]
    assert _findings(port) == _findings(ref)
    assert port.files_scanned == ref.files_scanned
    assert port.ok == ref.ok
    return port


def _materialize(tmp_path, tree):
    for rel, text in tree.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    return str(tmp_path)


# -------------------------------------------------------------- fixtures ---
@pytest.mark.parametrize("rule,idx", [(r, i) for r, trees in BAD.items()
                                      for i in range(len(trees))])
def test_bad_tree_flagged_by_both(tmp_path, rule, idx):
    report = _both(root=_materialize(tmp_path, BAD[rule][idx]),
                   rules=[rule])
    assert report.unsuppressed
    assert all(f.rule == rule for f in report.unsuppressed)


@pytest.mark.parametrize("rule", sorted(GOOD))
def test_good_tree_clean_under_both(tmp_path, rule):
    report = _both(root=_materialize(tmp_path, GOOD[rule]), rules=[rule])
    assert report.unsuppressed == []


SUPPRESSIONS = {
    "inline": ("    return time.time() + 1  "
               "# lint: allow[time-source] fixture: wall clock on purpose\n",
               True),
    "standalone": ("    # lint: allow[time-source] reason spans\n"
                   "    # a second comment line before the code\n"
                   "    return time.time() + 1\n", True),
    "other rule": ("    return time.time() + 1  "
                   "# lint: allow[durability-ordering] x\n", False),
}


@pytest.mark.parametrize("case", sorted(SUPPRESSIONS))
def test_suppressions_agree(tmp_path, case):
    body, silenced = SUPPRESSIONS[case]
    root = _materialize(tmp_path, {"core/a.py": (
        "import time\ndef backoff():\n" + body)})
    report = _both(root=root, rules=["time-source"])
    assert report.ok is silenced
    assert len(report.findings) == 1
    assert report.findings[0].suppressed is silenced


def test_baseline_round_trip_agrees(tmp_path):
    root = _materialize(tmp_path / "tree", BAD["time-source"][0])
    written = {}
    for name, tool in TOOLS.items():
        path = tmp_path / f"{name}.json"
        assert tool.cli(["--root", root, "--write-baseline",
                         str(path)]) == 0
        written[name] = path.read_text()
    assert written["port"] == written["reference"]
    # each tool reads the other's baseline
    report = _both(root=root, baseline=str(tmp_path / "reference.json"))
    assert report.ok and any(f.baselined for f in report.findings)
    (tmp_path / "tree" / "core" / "new.py").write_text(
        "import time\nDEADLINE = time.time() + 60\n")
    report = _both(root=root, baseline=str(tmp_path / "port.json"))
    assert not report.ok
    assert all(f.path == "core/new.py" for f in report.unsuppressed)


# ------------------------------------------------------------------- CLI ---
def _cli(tool, argv, capsys):
    rc = tool.cli(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("rule", sorted(BAD))
def test_cli_text_report_and_exit_code_agree(tmp_path, rule, capsys):
    root = _materialize(tmp_path, BAD[rule][0])
    out = {name: _cli(tool, ["--root", root, "--rule", rule], capsys)
           for name, tool in TOOLS.items()}
    assert out["port"][0] == out["reference"][0] == 1
    assert _fold(out["port"][1]) == out["reference"][1]
    assert "unsuppressed" in out["port"][1].splitlines()[-1]


@pytest.mark.parametrize("fmt", ["--json", "sarif"])
def test_cli_json_and_sarif_reports_agree(tmp_path, fmt, capsys):
    root = _materialize(tmp_path, GOOD["time-source"])
    (tmp_path / "core" / "b.py").write_text(
        "import time\nDEADLINE = time.time() + 60  "
        "# lint: allow[time-source] fixture\n")
    args = ["--json"] if fmt == "--json" else ["--format", "sarif"]
    out = {}
    for name, tool in TOOLS.items():
        rc, text = _cli(tool, ["--root", root, "--rule", "time-source"]
                        + args, capsys)
        assert rc == 0
        out[name] = json.loads(text)
    assert out["port"] == out["reference"]
    if fmt == "--json":
        assert out["port"]["counts"] == {"total": 1, "suppressed": 1,
                                         "baselined": 0, "unsuppressed": 0}
    else:
        assert [r["id"] for r in out["port"]["runs"][0]["tool"]["driver"]
                ["rules"]] == list(RULES)


def test_cli_list_rules_each_lists_its_own_seven(capsys):
    out = {name: _cli(tool, ["--list-rules"], capsys)
           for name, tool in TOOLS.items()}
    assert out["port"] == out["reference"]
    assert [line.split(":")[0] for line in
            out["port"][1].splitlines()] == list(RULES)


def test_cli_unknown_rule_errors_in_both(tmp_path):
    for tool in TOOLS.values():
        assert tool.cli(["--root", str(tmp_path), "--rule", "nope"]) == 2


def test_registries_are_separate():
    """Both cores keep a global registry: a rule registered on one side
    does not appear on the other, and each runner selects only its own."""
    assert r_core.CHECKERS is not t_core.CHECKERS
    assert sorted(r_core.CHECKERS) == sorted(t_core.CHECKERS) == list(RULES)
    assert all(cls.__module__.startswith("repro_torch.analysis.rules.")
               for cls in t_core.CHECKERS.values())
    assert all(cls.__module__.startswith("repro.analysis.rules.")
               for cls in r_core.CHECKERS.values())

    @t_core.register
    class _Extra(t_core.Checker):
        name = "port-only-extra"

    try:
        assert "port-only-extra" not in r_core.CHECKERS
        with pytest.raises(ValueError):
            r_core.run_analysis(root=str(ROOT / "docs"),
                                rules=["port-only-extra"])
    finally:
        del t_core.CHECKERS["port-only-extra"]


def test_defaults_point_at_the_port():
    assert Path(t_core.default_root()) == ROOT / "src" / "repro_torch"
    assert Path(r_core.default_root()) == ROOT / "src" / "repro"
    assert t_lockorder.LockOrderSanitizer()._package == "repro_torch"


# ------------------------------------------------------------ both trees ---
@pytest.mark.parametrize("tree", ["repro", "repro_torch"])
def test_both_tools_agree_over_each_source_tree(tree):
    report = _both(root=str(ROOT / "src" / tree))
    assert report.unsuppressed == [], "\n".join(
        f.render() for f in report.unsuppressed)
    assert report.files_scanned > 20
    assert any(f.suppressed for f in report.findings)


# -------------------------------------------------------------- doc drift --
def _spec_tree(tmp_path, package, doc_text):
    pkg = tmp_path / "src" / package / "analysis" / "protocol"
    pkg.mkdir(parents=True)
    (pkg / "spec.py").write_text("# stand-in for the wire spec\n")
    if doc_text is not None:
        (tmp_path / "docs").mkdir()
        (tmp_path / "docs" / "recovery.md").write_text(doc_text)
    return str(tmp_path / "src")


DOCS = {
    "missing doc": (None, "not found"),
    "missing markers": ("# recovery\n\nno table here\n", "missing"),
    "stale table": (f"# recovery\n{t_spec.WIRE_TABLE_BEGIN}\nstale rows\n"
                    f"{t_spec.WIRE_TABLE_END}\n", "disagrees"),
    "exact table": (f"# recovery\n{t_spec.WIRE_TABLE_BEGIN}\n"
                    f"{t_spec.render_wire_table()}{t_spec.WIRE_TABLE_END}\n",
                    None),
}


@pytest.mark.parametrize("case", sorted(DOCS))
@pytest.mark.parametrize("package", ["repro", "repro_torch"])
def test_doc_drift_agrees(tmp_path, case, package):
    text, flagged = DOCS[case]
    report = _both(root=_spec_tree(tmp_path, package, text),
                   rules=["wire-doc-drift"])
    if flagged is None:
        assert report.ok
    else:
        assert any(flagged in f.message for f in report.unsuppressed)


def test_live_docs_match_the_ports_spec():
    assert t_core.run_analysis(rules=["wire-doc-drift"]).ok


# ------------------------------------------------------------ wire table ---
def test_wire_table_and_cli_table_agree(capsys):
    assert t_spec.render_wire_table() == r_spec.render_wire_table()
    out = {name: _cli(SimpleNamespace(cli=tool.proto_cli), ["--table"],
                      capsys) for name, tool in TOOLS.items()}
    assert out["port"] == out["reference"]
    assert out["port"][1] == t_spec.render_wire_table()


def test_write_table_on_a_copy_of_the_doc(tmp_path, capsys):
    """The repo's docs/recovery.md already holds the spec's table: the
    port's generator reports it up to date and writes nothing; on a stale
    copy it regenerates what the reference's does."""
    doc = tmp_path / "recovery.md"
    shutil.copyfile(ROOT / "docs" / "recovery.md", doc)
    before = doc.read_bytes()
    assert t_proto_main.main(["--write-table", "--doc", str(doc)]) == 0
    assert "already up to date" in capsys.readouterr().out
    assert doc.read_bytes() == before
    assert Path(t_proto_main._default_doc()) == ROOT / "docs" / "recovery.md"

    stale = (f"preamble\n{t_spec.WIRE_TABLE_BEGIN}\nold\n"
             f"{t_spec.WIRE_TABLE_END}\ntail\n")
    got = {}
    for name, tool in TOOLS.items():
        path = tmp_path / f"{name}.md"
        path.write_text(stale)
        assert tool.proto_cli(["--write-table", "--doc", str(path)]) == 0
        got[name] = path.read_text()
    assert got["port"] == got["reference"]
    assert t_spec.render_wire_table() in got["port"]
    no_markers = tmp_path / "bare.md"
    no_markers.write_text("no markers\n")
    assert t_proto_main.main(["--write-table", "--doc",
                              str(no_markers)]) == 2


# ---------------------------------------------- spec drift over the port ---
def test_phantom_kind_in_the_ports_spec_fails_the_ports_analysis(
        monkeypatch):
    phantom = t_spec._f("phantom-op", t_spec.C2W, ("kind", "epoch"),
                        ("str", "int"), ("serving",), epoch_slot=1)
    monkeypatch.setitem(t_spec.FRAMES, ("phantom-op", t_spec.C2W), phantom)
    monkeypatch.setattr(t_spec, "KINDS", t_spec.KINDS | {"phantom-op"})
    report = t_core.run_analysis(rules=["protocol-conformance"])
    msgs = [f.message for f in report.unsuppressed]
    assert any("phantom-op" in m and "never constructed" in m for m in msgs)
    assert any("phantom-op" in m and "never dispatched" in m for m in msgs)
    assert not report.ok
    # the reference's analysis reads its own spec: untouched
    assert r_core.run_analysis(root=t_core.default_root(),
                               rules=["protocol-conformance"]).ok


def test_respecified_arity_in_the_ports_spec_fails_the_ports_analysis(
        monkeypatch):
    fat_drain = t_spec._f("drain", t_spec.C2W,
                          ("kind", "epoch", "token", "extra"),
                          ("str", "int", "any", "any"), ("serving",),
                          epoch_slot=1, section="fence")
    monkeypatch.setitem(t_spec.FRAMES, ("drain", t_spec.C2W), fat_drain)
    report = t_core.run_analysis(rules=["protocol-conformance"])
    assert any("'drain'" in f.message and "arity" in f.message
               for f in report.unsuppressed)
    assert not report.ok
    assert r_core.run_analysis(root=t_core.default_root(),
                               rules=["protocol-conformance"]).ok


# --------------------------------------------------------- model checker ---
def test_model_baseline_agrees():
    for scope in ("FAST", "FULL"):
        got = t_model.explore(getattr(t_model, scope))
        want = r_model.explore(getattr(r_model, scope))
        assert (got.states, got.transitions) == (want.states,
                                                 want.transitions)
        assert got.violation is None and want.violation is None
    assert sorted(t_model.MUTANTS) == sorted(r_model.MUTANTS)


@pytest.mark.parametrize("name", sorted(r_model.MUTANTS))
def test_model_mutant_caught_by_both(name):
    got = t_model.explore(t_model.FAST, mutant=name)
    want = r_model.explore(r_model.FAST, mutant=name)
    assert got.violation is not None
    assert tuple(got.violation) == tuple(want.violation)
    assert got.states == want.states
    assert len(got.trace) == len(want.trace) and got.trace == want.trace


def test_model_cli_check_agrees(capsys):
    out = {name: _cli(SimpleNamespace(cli=tool.proto_cli),
                      ["--check", "--fast"], capsys)
           for name, tool in TOOLS.items()}
    assert out["port"] == out["reference"]
    assert out["port"][0] == 0 and "NOT CAUGHT" not in out["port"][1]
    with pytest.raises(ValueError):
        t_model.explore(t_model.FAST, mutant="nope")


# -------------------------------------------------- lock-order sanitizer ---
def _nest(a, b):
    with a:
        with b:
            pass


def _in_thread(fn, *args):
    t = threading.Thread(target=fn, args=args)
    t.start()
    t.join()


def _abba(lo):
    san = lo.LockOrderSanitizer(package=None)
    a = san.wrap(threading.Lock(), "core/x.py:1")
    b = san.wrap(threading.Lock(), "core/y.py:2")
    _in_thread(_nest, a, b)
    _in_thread(_nest, b, a)
    cyc = san.find_cycle()
    assert cyc is not None and cyc[0] == cyc[-1]
    assert set(cyc) == {"core/x.py:1", "core/y.py:2"}
    with pytest.raises(lo.LockOrderError) as ei:
        san.assert_acyclic()
    assert "core/x.py:1" in str(ei.value)
    return sorted(san.edges()), cyc


def _consistent(lo):
    san = lo.LockOrderSanitizer(package=None)
    a = san.wrap(threading.Lock(), "a:1")
    b = san.wrap(threading.Lock(), "b:1")
    for _ in range(3):
        _in_thread(_nest, a, b)
    assert list(san.edges()) == [("a:1", "b:1")]
    san.assert_acyclic()
    return sorted(san.edges()), san.find_cycle()


def _rlock_reentry(lo):
    san = lo.LockOrderSanitizer(package=None)
    r = san.wrap(threading.RLock(), "r:1")
    with r:
        with r:
            pass
    assert san.edges() == {}
    return sorted(san.edges()), san.find_cycle()


def _same_site(lo):
    san = lo.LockOrderSanitizer(package=None)
    l1 = san.wrap(threading.Lock(), "s:1")
    l2 = san.wrap(threading.Lock(), "s:1")
    _in_thread(_nest, l1, l2)
    assert san.find_cycle() is not None
    return sorted(san.edges()), san.find_cycle()


def _failed_tryacquire(lo):
    san = lo.LockOrderSanitizer(package=None)
    a = san.wrap(threading.Lock(), "a:1")
    b = san.wrap(threading.Lock(), "b:1")
    b._inner.acquire()
    with a:
        assert b.acquire(blocking=False) is False
    b._inner.release()
    assert san.edges() == {}
    return sorted(san.edges()), san.find_cycle()


def _condition_reacquire(lo):
    san = lo.LockOrderSanitizer(package=None)
    cv = san.wrap_condition(None, "cv:1")
    a = san.wrap(threading.Lock(), "a:1")

    def waiter():
        with cv:
            with a:
                cv.wait(timeout=0.05)

    _in_thread(waiter)
    assert ("cv:1", "a:1") in san.edges()
    assert ("a:1", "cv:1") in san.edges()
    with pytest.raises(lo.LockOrderError):
        san.assert_acyclic()
    return sorted(san.edges()), san.find_cycle()


def _condition_roundtrip(lo):
    san = lo.LockOrderSanitizer(package=None)
    cv = san.wrap_condition(None, "cv:1")
    ready = threading.Event()
    woke = []

    def waiter():
        with cv:
            ready.set()
            woke.append(cv.wait(timeout=5))

    t = threading.Thread(target=waiter)
    t.start()
    assert ready.wait(5)
    with cv:
        cv.notify_all()
    t.join(5)
    assert woke == [True]
    assert san.edges() == {}
    return sorted(san.edges()), san.find_cycle()


LOCK_CASES = {"abba": _abba, "consistent order": _consistent,
              "rlock re-entry": _rlock_reentry,
              "same site, two instances": _same_site,
              "failed try-acquire": _failed_tryacquire,
              "condition wait reacquire": _condition_reacquire,
              "condition wait/notify": _condition_roundtrip}


@pytest.mark.parametrize("which", sorted(TOOLS))
@pytest.mark.parametrize("case", sorted(LOCK_CASES))
def test_lockorder_case(case, which):
    """Each case's own assertions hold under this sanitizer, and its
    graph (edges and the cycle found) equals the reference's."""
    got = LOCK_CASES[case](TOOLS[which].lockorder)
    assert got == LOCK_CASES[case](r_lockorder)


@pytest.mark.parametrize("which", sorted(TOOLS))
def test_install_tracks_only_its_own_package(which):
    """With both packages loaded, a sanitizer installed with its default
    package wraps the locks and conditions of its own package's source and
    leaves the other package's, and this file's, raw."""
    from repro.core.transport import _MuxChan as r_mux
    from repro.launch.shard_server import SessionRegistry as r_reg
    from repro_torch.core.transport import _MuxChan as t_mux
    from repro_torch.launch.shard_server import SessionRegistry as t_reg
    lo = TOOLS[which].lockorder
    san = lo.LockOrderSanitizer()
    own, other = (r_reg, r_mux), (t_reg, t_mux)
    if which == "port":
        own, other = other, own
    san.install()
    try:
        reg, chan = own[0](), own[1](None, 0)
        assert isinstance(reg.lock, lo._TrackedLock)
        assert reg.lock.site.startswith("launch/shard_server.py:")
        assert isinstance(chan._cv, lo._TrackedCondition)
        assert chan._cv.site.startswith("core/transport.py:")
        chan._deliver(("ack", 7, {}))
        assert chan.poll(1.0) is True and chan.recv() == ("ack", 7, {})
        reg, chan = other[0](), other[1](None, 0)
        for mod in (r_lockorder, t_lockorder):
            assert not isinstance(reg.lock, mod._TrackedLock)
            assert not isinstance(chan._cv, mod._TrackedCondition)
        assert not isinstance(threading.Lock(), lo._TrackedLock)
        assert not isinstance(threading.Condition(), lo._TrackedCondition)
    finally:
        san.uninstall()
    assert san.tracked_constructions == 2
    assert not isinstance(threading.Lock(), lo._TrackedLock)


# ----------------------------------------------------------------- fuzzer --
def test_ports_fuzzer_500_frames_every_category(tmp_path):
    """``tests/test_protocol_fuzz.py``'s acceptance bar on the port's
    fuzzer, server and fleet (tables on the CPU): >= 500 frames, every
    attack category fired, stale-epoch attacks fenced with ``stale``."""
    from repro_torch.analysis.protocol.fuzz import run_fuzz
    stats = run_fuzz(frames=500, seed=0, root=str(tmp_path), device="cpu")
    assert stats["ok"] and stats["frames"] >= 500
    assert len(stats["categories"]) == 10
    assert stats["replies"].get("stale", 0) > 0
    assert stats["disk_files"] > 0


# ---------------------------------------------------------------- configs --
@pytest.mark.parametrize("dataset", ["kaggle", "terabyte"])
def test_get_dlrm_config_equals_the_reference(dataset):
    got = dataclasses.asdict(t_get_dlrm_config(dataset))
    want = dataclasses.asdict(r_get_dlrm_config(dataset))
    assert got == want
    assert t_get_dlrm_config() == t_get_dlrm_config("kaggle")
    with pytest.raises(KeyError):
        t_get_dlrm_config("avazu")
