"""The port's blades-lint (blades_tpu_torch/tools/lint), its tier-1 budget
guard and its curve restamper, against the JAX package's tools.

Four layers:

1. **Fixture pairs** — every ported pass catches its seeded violations
   under ``tests/lint_fixtures/torch/`` and stays silent on the clean
   twin.
2. **Parity** — on the JAX lint's fixtures that mean the same over torch
   (``tracediscipline_*``, ``arrivalpurity_*``, ``schema_*``,
   ``pragma_*``), the port's pass gives the JAX pass's ``(line, pass)``
   findings; the budget guard's verdicts and the restamper's rewrite are
   the JAX tools' on the same inputs.
3. **CLI contract** — ``--json``, ``--list-passes``, exit codes.
4. **Enforcement** — ``python -m blades_tpu_torch.tools.lint`` exits 0 on
   this tree.
"""

import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from blades_tpu_torch.tools import check_tier1_budget as guard  # noqa: E402
from blades_tpu_torch.tools.lint import ERROR, core, run_passes  # noqa: E402
from blades_tpu_torch.tools.lint.core import (  # noqa: E402
    LintContext,
    collect_files,
)
from blades_tpu_torch.tools.lint.passes import ALL_PASSES  # noqa: E402
from blades_tpu_torch.tools.lint.passes.artifacts import (  # noqa: E402
    ArtifactStampsPass,
)
from blades_tpu_torch.tools.lint.passes.host_sync import (  # noqa: E402
    DEVICE_SIDE,
    HostSyncPass,
)
from blades_tpu_torch.tools.lint.passes.pass_discipline import (  # noqa: E402
    PassDisciplinePass,
)
from blades_tpu_torch.tools.lint.passes.schema_drift import (  # noqa: E402
    SchemaDriftPass,
)
from blades_tpu_torch.tools.lint.passes.topology_discipline import (  # noqa: E402
    TopologyDisciplinePass,
)
from blades_tpu_torch.tools.lint.passes.trace_discipline import (  # noqa: E402
    TraceDisciplinePass,
)

FIX = "tests/lint_fixtures"
TFIX = FIX + "/torch"
PASS_NAMES = ["host-sync", "schema-drift", "streamed-pass-discipline",
              "topology-discipline", "trace-discipline", "artifact-stamps"]


def run_fixture(passes, *names, where=TFIX):
    return run_passes(REPO, passes, only=[REPO / where / n for n in names])


def errors_of(findings, pass_name=None):
    return [f for f in findings if f.severity == ERROR
            and (pass_name is None or f.pass_name == pass_name)]


def lint_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "blades_tpu_torch.tools.lint", *args],
        capture_output=True, text=True, cwd=str(REPO), timeout=120)


# ---------------------------------------------------------------------------
# fixture pairs
# ---------------------------------------------------------------------------


def test_host_sync_fixtures():
    hs = HostSyncPass(modules=[f"{TFIX}/hostsync_bad.py"])
    bad = errors_of(run_fixture([hs], "hostsync_bad.py"), "host-sync")
    msgs = "\n".join(f.message for f in bad)
    for want in ("float() on a tensor expression",
                 "int() on a tensor expression",
                 "bool() on a tensor expression", ".item()", ".tolist()",
                 ".cpu()", ".numpy()", '.to("cpu")', "np.asarray()",
                 "np.array()", "torch.cuda.synchronize()",
                 "event.synchronize()", "mask.nonzero()",
                 "torch.nonzero()", "torch.masked_select()",
                 "torch.unique()"):
        assert want in msgs, want
    assert len(bad) == 17
    good = HostSyncPass(modules=[f"{TFIX}/hostsync_good.py"])
    assert run_fixture([good], "hostsync_good.py") == []


def test_trace_discipline_fixtures():
    tp = TraceDisciplinePass(prefixes=[f"{TFIX}/tracediscipline_bad.py"])
    bad = errors_of(run_fixture([tp], "tracediscipline_bad.py"),
                    "trace-discipline")
    msgs = "\n".join(f.message for f in bad)
    assert "time.perf_counter()" in msgs
    assert "perf_counter() (imported" in msgs
    assert "mono()" in msgs
    assert "time.time_ns()" in msgs
    assert len(bad) == 5
    tg = TraceDisciplinePass(prefixes=[f"{TFIX}/tracediscipline_good.py"])
    assert run_fixture([tg], "tracediscipline_good.py") == []


def test_topology_discipline_fixtures():
    tp = TopologyDisciplinePass(prefixes=[TFIX])
    bad = errors_of(run_fixture([tp], "topologydiscipline_bad.py"),
                    "topology-discipline")
    msgs = "\n".join(f.message for f in bad)
    for want in ("dist.all_reduce()", "tdist.broadcast()", "gather_objs()",
                 "torch.distributed.all_to_all_single()", "dist.barrier()"):
        assert want in msgs, want
    assert len(bad) == 5
    assert run_fixture([tp], "topologydiscipline_good.py") == []


def test_the_mesh_module_is_the_collectives_home():
    """parallel/mesh.py spells the raw collectives its counted helpers
    wrap, and is the one module the pass exempts; the span layer is
    trace-discipline's one home of raw clocks."""
    mesh = "blades_tpu_torch/parallel/mesh.py"
    assert (REPO / mesh).read_text().count("dist.all_") >= 4
    assert errors_of(run_fixture([TopologyDisciplinePass()], mesh, where="."),
                     "topology-discipline") == []
    trace = "blades_tpu_torch/obs/trace.py"
    assert "time.perf_counter()" in (REPO / trace).read_text()
    assert errors_of(run_fixture([TraceDisciplinePass()], trace, where="."),
                     "trace-discipline") == []


def test_pass_discipline_fixtures():
    bad = errors_of(run_fixture([PassDisciplinePass()],
                                "passdiscipline_bad.py"),
                    "streamed-pass-discipline")
    msgs = "\n".join(f.message for f in bad)
    for want in ("bundle()", "rowstats.row_stats_bundle()",
                 "rs.row_stats_bundle_plain()", "raw decode-to-f32 call "
                 "dequantize()", "cc.dequantize()"):
        assert want in msgs, want
    assert len(bad) == 5
    assert run_fixture([PassDisciplinePass()],
                       "passdiscipline_good.py") == []


def test_schema_drift_fixtures():
    sd = SchemaDriftPass(schema_module=f"{TFIX}/schema_mod.py",
                         stamp_modules=[f"{TFIX}/schema_stamp_bad.py"])
    findings = run_fixture([sd], "schema_mod.py", "schema_stamp_bad.py")
    bad = errors_of(findings, "schema-drift")
    assert sorted(f.message.split("'")[1] for f in bad) == [
        "mystery_key", "other_key"]
    warns = [f for f in findings if f.severity != ERROR]
    assert len(warns) == 1 and "never_stamped" in warns[0].message
    good = SchemaDriftPass(schema_module=f"{TFIX}/schema_mod.py",
                           stamp_modules=[f"{TFIX}/schema_stamp_good.py"])
    findings = run_fixture([good], "schema_mod.py", "schema_stamp_good.py")
    assert errors_of(findings) == []
    assert [f.message.split("'")[1] for f in findings] == ["never_stamped"]


def _mini_repo(tmp_path, curves_fixture):
    mod = tmp_path / "blades_tpu_torch" / "benchmarks"
    mod.mkdir(parents=True)
    (mod / "accuracy_curves.py").write_text(
        'REFERENCE_AGGREGATORS = ["Mean", "Median"]\n'
        "REFERENCE_MALICIOUS_FRACS = [0.0, 0.5]\n")
    art = tmp_path / "artifacts" / "cell"
    art.mkdir(parents=True)
    shutil.copy(REPO / TFIX / curves_fixture, art / "curves.json")
    return art / "curves.json"


@pytest.mark.parametrize("fixture,want", [
    ("curves_stale.json", ["stale complete: True"]),
    ("curves_current.json", []),
])
def test_artifact_stamps_fixtures(tmp_path, fixture, want):
    path = _mini_repo(tmp_path, fixture)
    before = path.read_bytes()
    found = list(ArtifactStampsPass().run(LintContext(tmp_path, [])))
    assert len(found) == len(want)
    for f, w in zip(found, want):
        assert w in f.message and f.path == "artifacts/cell/curves.json"
    # Read-only, and a partial scan never looks at artifacts.
    assert path.read_bytes() == before
    assert list(ArtifactStampsPass().run(
        LintContext(tmp_path, [], partial=True))) == []


# ---------------------------------------------------------------------------
# parity with the JAX lint on the fixtures that mean the same over torch
# ---------------------------------------------------------------------------


def _keys(findings):
    return sorted((f.line, f.pass_name, f.severity) for f in findings)


def _jax_and_port(kind, names):
    from tools.lint import run_passes as jax_run_passes
    from tools.lint.passes import host_sync as jhs
    from tools.lint.passes import schema_drift as jsd
    from tools.lint.passes import trace_discipline as jtd

    paths = [f"{FIX}/{n}" for n in names]
    if kind == "trace":
        jax_p = jtd.TraceDisciplinePass(prefixes=paths)
        port_p = TraceDisciplinePass(prefixes=paths)
    elif kind == "schema":
        jax_p = jsd.SchemaDriftPass(schema_module=paths[0],
                                    stamp_modules=paths[1:])
        port_p = SchemaDriftPass(schema_module=paths[0],
                                 stamp_modules=paths[1:])
    else:
        jax_p = jhs.HostSyncPass(modules=paths)
        port_p = HostSyncPass(modules=paths)
    only = [REPO / p for p in paths]
    return (jax_run_passes(REPO, [jax_p], only=only),
            run_passes(REPO, [port_p], only=only))


@pytest.mark.parametrize("kind,names", [
    ("trace", ["tracediscipline_bad.py"]),
    ("trace", ["tracediscipline_good.py"]),
    ("trace", ["arrivalpurity_bad.py"]),
    ("trace", ["arrivalpurity_good.py"]),
    ("schema", ["schema_mod.py", "schema_stamp_bad.py"]),
    ("schema", ["schema_mod.py", "schema_stamp_good.py"]),
    ("host", ["pragma_bad.py"]),
    ("host", ["pragma_suppressed.py"]),
])
def test_parity_with_the_jax_lint(kind, names):
    jax_found, port_found = _jax_and_port(kind, names)
    assert _keys(port_found) == _keys(jax_found)
    if names[-1].endswith("_bad.py"):
        assert errors_of(port_found)


# ---------------------------------------------------------------------------
# pragma grammar
# ---------------------------------------------------------------------------


def test_pragma_requires_reason_and_real_pass_name():
    hs = HostSyncPass(modules=[f"{FIX}/pragma_bad.py"])
    findings = run_fixture([hs], "pragma_bad.py", where=FIX)
    pragma = [f for f in findings if f.pass_name == "pragma"]
    assert any("without a justification" in f.message for f in pragma)
    assert any("unknown pass(es) ['host-sink']" in f.message
               for f in pragma)
    hs_findings = errors_of(findings, "host-sync")
    assert len(hs_findings) == 1 and hs_findings[0].line == 10


def test_pragma_in_string_is_not_live(tmp_path):
    f = tmp_path / "docstrings.py"
    f.write_text(
        '"""Grammar doc:\n'
        "``# blades-lint: disable-file=host-sync — example``\n"
        '"""\n'
        'S = "# blades-lint: disable=all — in a string"\n'
        "x = 1  # blades-lint: disable=host-sync — a REAL comment pragma\n"
    )
    sf = core.SourceFile(f, tmp_path)
    assert len(sf.pragmas) == 1 and sf.pragmas[0].line == 5
    assert not sf.disabled("host-sync", 2)
    assert sf.disabled("host-sync", 5)


def test_jax_only_pass_names_are_unknown_here(tmp_path):
    """The passes with no torch counterpart are not registered: a pragma
    naming one in the port's tree is reported."""
    f = tmp_path / "mod.py"
    f.write_text("x = 1  # blades-lint: disable=prng-reuse — not a port "
                 "pass\n")
    found = run_passes(tmp_path, ALL_PASSES, only=[f])
    assert [x.message for x in found] == [
        "pragma names unknown pass(es) ['prng-reuse']"]


# ---------------------------------------------------------------------------
# CLI and the tree
# ---------------------------------------------------------------------------


def test_cli_json_and_exit_codes():
    r = lint_cli("--json", f"{TFIX}/passdiscipline_bad.py")
    assert r.returncode == 1
    payload = json.loads(r.stdout)
    assert payload["summary"]["errors"] == 5
    assert payload["summary"]["passes"] == PASS_NAMES
    assert {"pass_name", "path", "line", "message", "fix_hint",
            "severity"} <= set(payload["findings"][0])
    assert lint_cli("--no-such-flag").returncode == 2


def test_cli_lists_six_passes():
    r = lint_cli("--list-passes")
    assert r.returncode == 0
    assert [ln.split()[0] for ln in r.stdout.splitlines() if ln] == \
        PASS_NAMES


def test_repo_tree_is_clean():
    """``python -m blades_tpu_torch.tools.lint`` over the port, its tests
    and chip_smoke.py: zero errors and zero warnings."""
    r = lint_cli("--json")
    assert r.returncode == 0, r.stdout[-4000:]
    payload = json.loads(r.stdout)
    assert payload["summary"]["errors"] == 0
    assert payload["findings"] == []
    # The core's own checks run beside the passes.
    assert not any(f["pass_name"] in ("pragma", "parse")
                   for f in payload["findings"])


def test_tree_scan_covers_the_port_and_skips_fixtures():
    files = {f.rel for f in collect_files(REPO)}
    assert "chip_smoke.py" in files
    assert "blades_tpu_torch/core/round.py" in files
    assert "blades_tpu_torch/tools/lint/core.py" in files
    assert "tests/test_torch_lint.py" in files
    assert not any("lint_fixtures" in rel for rel in files)
    assert not any(rel.startswith(("blades_tpu/", "tools/"))
                   or rel in ("tests/test_lint.py", "bench.py")
                   for rel in files)


def test_device_side_modules_exist_and_map_the_pallas_modules():
    from tools.lint.passes.host_sync import DEVICE_SIDE as JAX_SIDE

    assert all((REPO / rel).is_file() for rel in DEVICE_SIDE)
    assert len(set(DEVICE_SIDE)) == len(DEVICE_SIDE)
    for pallas, port in (("pallas_round", "fused_finish"),
                         ("pallas_round", "bn_backward"),
                         ("pallas_rowstats", "rowstats"),
                         ("pallas_select", "column_select")):
        assert f"blades_tpu/ops/{pallas}.py" in JAX_SIDE
        assert f"blades_tpu_torch/ops/{port}.py" in DEVICE_SIDE
    # Every other JAX entry has its counterpart at the same path.
    for rel in JAX_SIDE:
        if "/pallas_" not in rel:
            assert rel.replace("blades_tpu/", "blades_tpu_torch/", 1) \
                in DEVICE_SIDE


def test_stale_device_side_list_is_reported(tmp_path):
    (tmp_path / "blades_tpu_torch").mkdir()
    found = list(HostSyncPass().run(LintContext(tmp_path, [])))
    assert len(found) == len(DEVICE_SIDE)
    assert all("module list is stale" in f.message for f in found)
    # A partial scan of an explicit module list says nothing.
    assert list(HostSyncPass(modules=["gone.py"]).run(
        LintContext(tmp_path, []))) == []


# ---------------------------------------------------------------------------
# the budget guard and the restamper against the JAX tools
# ---------------------------------------------------------------------------

_LOG = textwrap.dedent("""\
    ........ [100%]
    ============ slowest 3 durations ============
    46.46s call     tests/test_obs.py::test_sweep
    12.00s call     tests/test_x.py::test_y
    0.50s setup    tests/test_x.py::test_y
    ====== 2316 passed, 1 skipped in {total} (0:18:55) ======
""")


@pytest.mark.parametrize("total,ok", [
    ("1135.00s", True), ("1249.00s", True), ("1300.00s", False),
    (None, True)])
def test_budget_guard_matches_the_jax_guard(tmp_path, total, ok):
    sys.path.insert(0, str(REPO / "tools"))
    import check_tier1_budget as jax_guard

    text = (_LOG.format(total=total) if total else
            "\n".join(ln for ln in _LOG.splitlines() if "passed" not in ln))
    assert guard.projected_tier1_seconds(text) == \
        jax_guard.projected_tier1_seconds(text)
    assert guard.parse_durations(text) == jax_guard.parse_durations(text)
    log = tmp_path / "t1.log"
    log.write_text(text)
    ours = guard.check_budget(log, guard.CAP_SECONDS, guard.THRESHOLD)
    theirs = jax_guard.check_budget(log, 1470.0, 0.85)
    assert ours == theirs and (ours == []) == ok
    assert guard.CAP_SECONDS == 1470.0 and guard.THRESHOLD == 0.85
    assert guard.check_budget(tmp_path / "absent.log", 1470.0, 0.85)


def test_budget_guard_cli(tmp_path):
    log = tmp_path / "t1.log"
    cmd = [sys.executable, "-m", "blades_tpu_torch.tools.check_tier1_budget",
           "--log", str(log)]
    log.write_text(_LOG.format(total="1135.00s"))
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=str(REPO))
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr
    log.write_text(_LOG.format(total="1300.00s"))
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=str(REPO))
    assert r.returncode == 1
    assert "1300.0s exceeds 85% of the 1470s cap" in r.stderr
    assert "test_obs.py::test_sweep" in r.stderr


def test_restamp_curves_matches_the_jax_restamper(tmp_path):
    stale = {"num_clients": 60, "complete": True, "seed": 3,
             "planned": {"aggregators": ["Mean"], "malicious": [0]},
             "rows": [{"aggregator": "Mean", "num_malicious": 0}]}
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    for p in (ours, theirs):
        p.write_text(json.dumps(stale))
    port = [sys.executable, "-m", "blades_tpu_torch.tools.restamp_curves"]
    r = subprocess.run(port + ["--check", str(ours)],
                       capture_output=True, text=True, cwd=str(REPO))
    assert r.returncode == 1 and "True -> False" in r.stdout
    assert json.loads(ours.read_text()) == stale  # --check writes nothing
    for cmd, p in ((port, ours),
                   ([sys.executable, str(REPO / "tools" / "restamp_curves.py")],
                    theirs)):
        r = subprocess.run(cmd + [str(p)], capture_output=True, text=True,
                           cwd=str(REPO))
        assert r.returncode == 0, r.stderr
    assert ours.read_bytes() == theirs.read_bytes()
    data = json.loads(ours.read_text())
    assert data["complete"] is False and data["planned_complete"] is True
    assert data["seed"] == 3 and data["rows"] == stale["rows"]
    r = subprocess.run(port + ["--check", str(ours)],
                       capture_output=True, text=True, cwd=str(REPO))
    assert r.returncode == 0  # stamps now current
