"""The port's invariant analyzer (corda_tpu_torch/analysis) against the JAX
package's: the mirror of tests/test_static_analysis.py.

The first class is the port's tree gate: zero live findings over
``corda_tpu_torch`` with an empty baseline. Every rule fixture of the
reference file runs through both analyzers, its path rebased to
``corda_tpu_torch/...`` for the port, and must give the same rules, lines,
suppressions and baseline absorptions. The fixtures of the two lists the
port renames (``jax.jit`` / ``Mesh`` -> the port's kernel builds,
``torch.compile`` and ``make_mesh``; ``block_until_ready`` ->
``synchronize``) are written in the port's idiom, and the port's finding
must sit on the line where the reference's analyzer finds the JAX idiom.
No wall-clock budget is asserted here.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from corda_tpu.analysis import analyze_source as ref_analyze_source
from corda_tpu_torch.analysis import (
    ALL_RULES,
    DEFAULT_BASELINE,
    analyze_paths,
    analyze_source,
    baseline_entries_from_findings,
    load_baseline,
)
from corda_tpu_torch.analysis.__main__ import main as cli_main

REPO = Path(__file__).resolve().parents[1]
TREE = REPO / "corda_tpu_torch"

RAFT = "node/services/raft.py"  # in scope for the wallclock rule
NODE_X = "node/x.py"


def _rules(report):
    return [f.rule for f in report.findings]


def _shape(report):
    return ([(f.rule, f.line) for f in report.findings],
            len(report.suppressed), len(report.baselined))


def _rebase(entries, pkg):
    return [dict(e, path=f"{pkg}/{e['path']}") for e in entries] \
        if entries else None


def both(src, rel, entries=None, ref_src=None):
    """The port's report on ``src`` at ``corda_tpu_torch/<rel>``, after
    checking that the reference's analyzer gives the same findings (rule
    and line), suppressions and baseline absorptions on ``ref_src`` (the
    same source unless given) at ``corda_tpu/<rel>``."""
    port = analyze_source(src, f"corda_tpu_torch/{rel}",
                          baseline_entries=_rebase(entries,
                                                   "corda_tpu_torch"))
    ref = ref_analyze_source(ref_src or src, f"corda_tpu/{rel}",
                             baseline_entries=_rebase(entries, "corda_tpu"))
    assert _shape(port) == _shape(ref), (port.findings, ref.findings)
    return port


# ---------------------------------------------------------------------------
# The port's tree gate
# ---------------------------------------------------------------------------


class TestTreeGate:
    def test_tree_has_zero_unbaselined_findings(self):
        report = analyze_paths([TREE])
        assert len(report.rules) >= 6
        assert report.checked_files > 100
        rendered = "\n".join(f.render() for f in report.findings)
        assert report.clean, f"live invariant findings:\n{rendered}"
        assert not report.baselined

    def test_every_suppression_in_tree_was_exercised(self):
        report = analyze_paths([TREE])
        assert len(report.suppressed) >= 15

    def test_ingest_hot_path_is_in_scope_and_clean(self):
        report = analyze_paths([TREE / "tools" / "ingest.py",
                                TREE / "crypto" / "batch_sign.py",
                                TREE / "tools" / "loadgen.py"])
        assert report.checked_files == 3
        rendered = "\n".join(f.render() for f in report.findings)
        assert report.clean, f"ingest-plane findings:\n{rendered}"

    def test_checked_in_baseline_is_the_ports_and_empty(self):
        path = REPO / "corda_tpu_torch/analysis/baseline.json"
        assert DEFAULT_BASELINE == path
        assert load_baseline(path) == []

    def test_reports_are_scoped_to_the_port_package(self):
        report = analyze_paths([TREE / "node" / "services" / "raft.py"],
                               use_baseline=False)
        assert report.suppressed
        assert all(f.path == "corda_tpu_torch/node/services/raft.py"
                   for f in report.suppressed)

    def test_repaired_sites_carry_their_reasons(self):
        # The five reasoned allow() comments the copies had lost, restored
        # with the reference's reasons, and the stop() drain's handler,
        # narrowed: each site is suppressed or clean, none is live.
        sites = {
            "crypto/fast_ed25519.py": "no-silent-except",
            "crypto/provider.py": "no-jit-in-hotpath",
            "crypto/sidecar.py": "no-blocking-under-lock",
            "node/verify_client.py": "no-blocking-under-lock",
        }
        for rel, rule in sites.items():
            report = analyze_paths([TREE / rel], use_baseline=False)
            assert report.clean, rel
            assert rule in [f.rule for f in report.suppressed], rel
        assert len([f for f in analyze_paths(
            [TREE / "node/verify_client.py"]).suppressed
            if f.rule == "no-blocking-under-lock"]) == 2
        node = analyze_paths([TREE / "node/node.py"], use_baseline=False)
        assert node.clean
        assert "except queue.Full:" in (TREE / "node/node.py").read_text()

    def test_reference_analyzer_finds_nothing_in_the_port(self, monkeypatch):
        # The JAX package's analyzer, unchanged, over every port file at
        # its rebased path: the port's tree passes both rule sets. Its
        # span-name rule reads the reference's registry plus exactly the
        # port's own provider spans.
        from corda_tpu.analysis import rules as ref_rules
        from corda_tpu.obs import stages as jstages
        from corda_tpu_torch.obs import stages

        rule = next(r for r in ref_rules.ALL_RULES
                    if r.name == "trace-stage-registry")
        monkeypatch.setattr(rule, "_registry", lambda: (
            jstages.SPAN_NAMES | frozenset(stages.PROVIDER_SPANS),
            jstages.SPAN_NAME_PREFIXES))
        live = []
        for path in sorted(TREE.rglob("*.py")):
            rel = path.relative_to(TREE).as_posix()
            report = ref_analyze_source(path.read_text(), f"corda_tpu/{rel}")
            live += [f.render() for f in report.findings]
        assert not live, "\n".join(live)

    def test_module_cli_exits_zero_on_the_port(self):
        out = subprocess.run(
            [sys.executable, "-m", "corda_tpu_torch.analysis"],
            cwd=REPO, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stdout + out.stderr
        assert out.stdout.strip().splitlines()[-1].startswith("0 finding(s)")


# ---------------------------------------------------------------------------
# Rule fixtures: violating + clean + suppressed (+ baselined)
# ---------------------------------------------------------------------------


class TestNoWallclockInApply:
    def test_replica_side_epoch_read_goes_red(self):
        src = (
            "import time as _time\n"
            "def _apply_reserve(db, cmd):\n"
            "    return _time.time() > cmd.issued_at + cmd.ttl_s\n"
        )
        assert "no-wallclock-in-apply" in _rules(both(src, RAFT))

    def test_monotonic_inside_apply_goes_red(self):
        src = (
            "import time\n"
            "def make_apply_command(db):\n"
            "    def helper():\n"
            "        return time.monotonic()\n"
            "    return helper\n"
        )
        assert "no-wallclock-in-apply" in _rules(both(src, RAFT))

    def test_monotonic_deadline_outside_apply_is_clean(self):
        src = (
            "import time as _time\n"
            "def poll(deadline):\n"
            "    return _time.monotonic() >= deadline\n"
        )
        assert "no-wallclock-in-apply" not in _rules(both(src, RAFT))

    def test_out_of_scope_file_is_ignored(self):
        src = "import time\nx = time.time()\n"
        assert "no-wallclock-in-apply" not in _rules(
            both(src, "tools/loadtest.py"))

    def test_real_coordinator_stamping_sites_stay_green(self):
        report = analyze_paths(
            [TREE / "node/services/sharding.py",
             TREE / "node/services/raft.py"],
            use_baseline=False)
        assert "no-wallclock-in-apply" not in _rules(report)
        stamped = [f for f in report.suppressed
                   if f.rule == "no-wallclock-in-apply"]
        assert len(stamped) >= 3


class TestNoSilentExcept:
    VIOLATION = (
        "def f(handler):\n"
        "    try:\n"
        "        handler()\n"
        "    except Exception:\n"
        "        pass\n"
    )

    def test_silent_pass_goes_red(self):
        assert "no-silent-except" in _rules(both(self.VIOLATION, NODE_X))

    def test_bare_except_goes_red(self):
        src = "def f(g):\n    try:\n        g()\n    except:\n        pass\n"
        assert "no-silent-except" in _rules(both(src, NODE_X))

    def test_narrowed_or_counting_handler_is_clean(self):
        src = (
            "def f(handler, metrics):\n"
            "    try:\n"
            "        handler()\n"
            "    except (LookupError, ValueError):\n"
            "        pass\n"
            "    try:\n"
            "        handler()\n"
            "    except Exception:\n"
            "        metrics['fails'] += 1\n"
        )
        assert "no-silent-except" not in _rules(both(src, NODE_X))

    def test_reasoned_allow_suppresses(self):
        src = (
            "def f(handler):\n"
            "    try:\n"
            "        handler()\n"
            "    # lint: allow(no-silent-except) demo tooling, retried next tick\n"
            "    except Exception:\n"
            "        pass\n"
        )
        report = both(src, "tools/x.py")
        assert "no-silent-except" not in _rules(report)
        assert len(report.suppressed) == 1

    def test_baseline_absorbs_enumerated_site(self):
        entries = [{"rule": "no-silent-except", "path": NODE_X,
                    "code": "except Exception:", "count": 1,
                    "reason": "pre-existing, tracked"}]
        report = both(self.VIOLATION, NODE_X, entries)
        assert "no-silent-except" not in _rules(report)
        assert len(report.baselined) == 1

    def test_stop_drain_handler_shape_is_clean(self):
        # node.py's stop(): a full queue is the one failure the shutdown
        # mark can meet; the narrowed handler logs it.
        src = (
            "import logging\n"
            "import queue\n"
            "def stop(q):\n"
            "    try:\n"
            "        q.put(None, timeout=1.0)\n"
            "    except queue.Full:\n"
            "        logging.getLogger('x').warning('still full')\n"
        )
        assert "no-silent-except" not in _rules(both(src, NODE_X))


# The reference's no-jit fixtures in JAX's idiom, and the port's in its own:
# each pair has its call on the same line.
JIT_PAIRS = {
    "jit_inside_per_batch_function": (
        "import jax\n"
        "def verify_batch(fn, xs):\n"
        "    return jax.jit(fn)(xs)\n",
        "import torch\n"
        "def verify_batch(fn, xs):\n"
        "    return torch.compile(fn)(xs)\n", True),
    "mesh_construction_inside_function": (
        "from jax.sharding import Mesh\n"
        "def dispatch(devs, xs):\n"
        "    return Mesh(devs, ('sigs',))\n",
        "from corda_tpu_torch.ops.sharded import make_mesh\n"
        "def dispatch(devs, xs):\n"
        "    return make_mesh(len(devs), devs)\n", True),
    "module_level_and_cached_builders": (
        "import functools\n"
        "import jax\n"
        "def _graph(x):\n"
        "    return x\n"
        "verify = jax.jit(_graph)\n"
        "@functools.lru_cache(maxsize=None)\n"
        "def builder(mesh):\n"
        "    return jax.jit(_graph)\n",
        "import functools\n"
        "import torch\n"
        "def _graph(x):\n"
        "    return x\n"
        "verify = torch.compile(_graph)\n"
        "@functools.lru_cache(maxsize=None)\n"
        "def builder(mesh):\n"
        "    return torch.compile(_graph)\n", False),
    "module_level_jit_decorator": (
        "import jax\n"
        "@jax.jit\n"
        "def verify_arrays(x):\n"
        "    return x\n",
        "import torch\n"
        "@torch.compile\n"
        "def verify_arrays(x):\n"
        "    return x\n", False),
}


class TestNoJitInHotpath:
    @pytest.mark.parametrize("case", sorted(JIT_PAIRS))
    def test_fixture_in_the_ports_idiom(self, case):
        ref_src, port_src, red = JIT_PAIRS[case]
        report = both(port_src, "ops/x.py", ref_src=ref_src)
        assert ("no-jit-in-hotpath" in _rules(report)) is red

    @pytest.mark.parametrize("call", [
        "torch.utils.cpp_extension.load(name='k', sources=[src])",
        "cpp_extension.load_inline(name='k', cpp_sources=[src])",
        "load_inline('k', [src])",
        "_build.load(src)",
        "_build.build_all()",
        "torch.compile(src)",
    ])
    def test_per_call_build_goes_red(self, call):
        src = f"def launch(src):\n    return {call}\n"
        report = analyze_source(src, "corda_tpu_torch/ops/x.py")
        assert _rules(report) == ["no-jit-in-hotpath"]
        assert report.findings[0].line == 2

    @pytest.mark.parametrize("call", [
        "json.load(src)", "re.compile(src)", "pickle.load(src)",
        "self.compile(src)", "lib.load(src)"])
    def test_common_load_and_compile_calls_stay_clean(self, call):
        src = f"def parse(self, src, lib):\n    return {call}\n"
        assert not analyze_source(src, "corda_tpu_torch/ops/x.py").findings


class TestNoBlockingUnderLock:
    def test_socket_send_under_lock_goes_red(self):
        src = (
            "import threading\n"
            "class C:\n"
            "    def __init__(self, sock):\n"
            "        self._lock = threading.Lock()\n"
            "        self.sock = sock\n"
            "    def send(self, buf):\n"
            "        with self._lock:\n"
            "            self.sock.sendall(buf)\n"
        )
        assert "no-blocking-under-lock" in _rules(both(src, NODE_X))

    def test_sqlite_under_designated_db_lock_is_exempt(self):
        src = (
            "class C:\n"
            "    def put(self, row):\n"
            "        with self.db.lock:\n"
            "            self.db.conn.execute('INSERT', row)\n"
            "            self.db.conn.commit()\n"
        )
        assert "no-blocking-under-lock" not in _rules(both(src, NODE_X))

    def test_copy_under_lock_send_outside_is_clean(self):
        src = (
            "import threading\n"
            "class C:\n"
            "    def __init__(self, sock):\n"
            "        self._lock = threading.Lock()\n"
            "        self.sock = sock\n"
            "        self.queue = []\n"
            "    def flush(self):\n"
            "        with self._lock:\n"
            "            batch = list(self.queue)\n"
            "        self.sock.sendall(b''.join(batch))\n"
        )
        assert "no-blocking-under-lock" not in _rules(both(src, NODE_X))

    def test_condition_wait_is_exempt(self):
        src = (
            "import threading\n"
            "class C:\n"
            "    def __init__(self):\n"
            "        self._cv = threading.Condition()\n"
            "    def park(self):\n"
            "        with self._cv:\n"
            "            self._cv.wait(0.1)\n"
        )
        assert "no-blocking-under-lock" not in _rules(both(src, NODE_X))

    def test_allow_on_with_line_suppresses(self):
        src = (
            "import threading\n"
            "class C:\n"
            "    def __init__(self, sock):\n"
            "        self._lock = threading.Lock()\n"
            "        self.sock = sock\n"
            "    def send(self, buf):\n"
            "        # lint: allow(no-blocking-under-lock) this lock serializes the socket\n"
            "        with self._lock:\n"
            "            self.sock.sendall(buf)\n"
        )
        report = both(src, NODE_X)
        assert "no-blocking-under-lock" not in _rules(report)
        assert len(report.suppressed) == 1

    def test_device_synchronize_under_lock_goes_red(self):
        # The port's device wait where the reference counts
        # block_until_ready: both on the with-statement's line.
        body = (
            "import threading\n"
            "class C:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "    def drain(self, out):\n"
            "        with self._lock:\n"
            "            {call}\n"
        )
        report = both(body.format(call="torch.cuda.synchronize()"), NODE_X,
                      ref_src=body.format(call="out.block_until_ready()"))
        assert _rules(report) == ["no-blocking-under-lock"]
        assert report.findings[0].line == 6
        assert "synchronize()" in report.findings[0].message


class TestLockOrder:
    def test_acquisition_cycle_goes_red(self):
        src = (
            "import threading\n"
            "class C:\n"
            "    def __init__(self):\n"
            "        self._a = threading.Lock()\n"
            "        self._b_lock = threading.Lock()\n"
            "    def f(self):\n"
            "        with self._a:\n"
            "            with self._b_lock:\n"
            "                pass\n"
            "    def g(self):\n"
            "        with self._b_lock:\n"
            "            with self._a:\n"
            "                pass\n"
        )
        assert "lock-order" in _rules(both(src, NODE_X))

    def test_self_reacquire_goes_red(self):
        src = (
            "import threading\n"
            "class C:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "    def f(self):\n"
            "        with self._lock:\n"
            "            with self._lock:\n"
            "                pass\n"
        )
        assert "lock-order" in _rules(both(src, NODE_X))

    def test_consistent_global_order_is_clean(self):
        src = (
            "import threading\n"
            "class C:\n"
            "    def __init__(self):\n"
            "        self._a = threading.Lock()\n"
            "    def f(self, other):\n"
            "        with self._a:\n"
            "            with other.stats_lock:\n"
            "                pass\n"
            "    def g(self, other):\n"
            "        with self._a:\n"
            "            with other.stats_lock:\n"
            "                pass\n"
        )
        assert "lock-order" not in _rules(both(src, NODE_X))

    def test_same_attr_in_different_classes_is_not_a_cycle(self):
        src = (
            "import threading\n"
            "class A:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "        self.peer_lock = threading.Lock()\n"
            "    def f(self):\n"
            "        with self._lock:\n"
            "            with self.peer_lock:\n"
            "                pass\n"
            "class B:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "        self.peer_lock = threading.Lock()\n"
            "    def g(self):\n"
            "        with self.peer_lock:\n"
            "            with self._lock:\n"
            "                pass\n"
        )
        assert "lock-order" not in _rules(both(src, NODE_X))


class TestTraceStageRegistry:
    def test_unregistered_literal_goes_red(self):
        src = (
            "from ..obs import trace as _obs\n"
            "def f(t0, t1):\n"
            "    _obs.record('device_vrfy', t0, t1)\n"
        )
        assert "trace-stage-registry" in _rules(both(src, NODE_X))

    def test_registered_names_and_flow_prefix_are_clean(self):
        src = (
            "from ..obs import trace as _obs\n"
            "def f(t0, t1, name):\n"
            "    _obs.record('device_verify', t0, t1)\n"
            "    _obs.record('raft_commit', t0, t1)\n"
            "    _obs.record(f'flow:{name}', t0, t1)\n"
        )
        assert "trace-stage-registry" not in _rules(both(src, NODE_X))

    def test_unregistered_dynamic_prefix_goes_red(self):
        src = (
            "from ..obs import trace as _obs\n"
            "def f(t0, t1, name):\n"
            "    _obs.record(f'stage:{name}', t0, t1)\n"
        )
        assert "trace-stage-registry" in _rules(both(src, NODE_X))

    def test_variable_names_and_obs_internal_sites_are_skipped(self):
        src = (
            "from ..obs import trace as _obs\n"
            "def f(t0, t1, name):\n"
            "    _obs.record(name, t0, t1)\n"
        )
        assert "trace-stage-registry" not in _rules(both(src, NODE_X))
        red = "from . import trace as _obs\ndef f():\n    _obs.record('x', 0, 1)\n"
        assert "trace-stage-registry" not in _rules(
            both(red, "obs/collect.py"))

    def test_registry_and_breakdown_share_one_source_of_truth(self):
        from corda_tpu_torch.obs import collect, stages

        assert collect.STAGES is stages.STAGES
        assert set(stages.BATCH_STAGES) <= set(stages.STAGES)
        assert set(stages.DIRECT_STAGES) <= set(stages.STAGES)
        assert set(stages.DERIVED_STAGES) <= set(stages.STAGES)

    def test_the_rule_reads_the_ports_registries(self):
        from corda_tpu_torch.analysis import rules
        from corda_tpu_torch.obs import stages, telemetry

        rule = next(r for r in rules.ALL_RULES
                    if r.name == "trace-stage-registry")
        assert rule._registry() == (stages.SPAN_NAMES,
                                    stages.SPAN_NAME_PREFIXES)
        assert rule._metric_registry() is telemetry.METRIC_NAMES

    def test_unregistered_telemetry_metric_goes_red(self):
        src = (
            "from ..obs import telemetry as _tm\n"
            "def f():\n"
            "    _tm.inc('verify_batchs_total')\n"
            "    _tm.observe('round_wall_seconds', 0.1)\n"
        )
        assert _rules(both(src, NODE_X)).count("trace-stage-registry") == 1

    def test_registered_telemetry_metric_names_are_clean(self):
        src = (
            "from ..obs import telemetry as _tm\n"
            "from ..obs.telemetry import inc\n"
            "def f(n):\n"
            "    _tm.inc('verify_batches_total')\n"
            "    _tm.observe('verify_batch_sigs', n)\n"
            "    inc('rounds_total')\n"
        )
        assert "trace-stage-registry" not in _rules(both(src, NODE_X))

    def test_from_imported_inc_with_unknown_name_goes_red(self):
        src = (
            "from ..obs.telemetry import inc as _inc\n"
            "def f():\n"
            "    _inc('made_up_total')\n"
        )
        assert "trace-stage-registry" in _rules(both(src, NODE_X))

    def test_variable_metric_names_are_skipped(self):
        src = (
            "from ..obs import telemetry as _tm\n"
            "def f(name):\n"
            "    _tm.inc(name)\n"
        )
        assert "trace-stage-registry" not in _rules(both(src, NODE_X))


# ---------------------------------------------------------------------------
# Suppression + baseline machinery
# ---------------------------------------------------------------------------


class TestSuppressions:
    def test_allow_without_reason_is_itself_a_finding(self):
        src = (
            "def f(g):\n"
            "    try:\n"
            "        g()\n"
            "    # lint: allow(no-silent-except)\n"
            "    except Exception:\n"
            "        pass\n"
        )
        rules = _rules(both(src, NODE_X))
        assert "bad-suppression" in rules
        assert "no-silent-except" in rules

    def test_allow_naming_unknown_rule_is_a_finding(self):
        src = "# lint: allow(no-such-rule) because reasons\nx = 1\n"
        assert "bad-suppression" in _rules(both(src, NODE_X))

    def test_trailing_allow_on_same_line_works(self):
        src = (
            "import time as _time\n"
            "def f():\n"
            "    return _time.time()  # lint: allow(no-wallclock-in-apply) coordinator stamp\n"
        )
        report = both(src, RAFT)
        assert "no-wallclock-in-apply" not in _rules(report)
        assert len(report.suppressed) == 1


class TestBaseline:
    def test_round_trip(self):
        src = TestNoSilentExcept.VIOLATION
        first = analyze_source(src, "corda_tpu_torch/node/x.py")
        entries = baseline_entries_from_findings(first.findings,
                                                 "accepted pre-existing")
        second = analyze_source(src, "corda_tpu_torch/node/x.py",
                                baseline_entries=entries)
        assert second.clean
        assert len(second.baselined) == len(first.findings)

    def test_entry_for_missing_file_goes_stale(self):
        entries = [{"rule": "no-silent-except", "path": "node/deleted.py",
                    "code": "except Exception:", "count": 1,
                    "reason": "was accepted"}]
        assert "stale-baseline" in _rules(both("x = 1\n", NODE_X, entries))

    def test_unmatched_and_reasonless_entries_go_stale(self):
        entries = [
            {"rule": "no-silent-except", "path": NODE_X,
             "code": "except Exception:", "count": 1, "reason": "fixed?"},
            {"rule": "no-silent-except", "path": NODE_X,
             "code": "except BaseException:", "count": 1, "reason": ""},
        ]
        report = both("x = 1\n", NODE_X, entries)
        assert _rules(report).count("stale-baseline") == 2

    def test_budget_absorbs_count_then_surfaces_excess(self):
        src = TestNoSilentExcept.VIOLATION * 2
        entries = [{"rule": "no-silent-except", "path": NODE_X,
                    "code": "except Exception:", "count": 1,
                    "reason": "only one accepted"}]
        report = both(src, NODE_X, entries)
        assert _rules(report).count("no-silent-except") == 1
        assert len(report.baselined) == 1


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


class TestCli:
    def test_json_mode_and_exit_codes(self, tmp_path, capsys):
        bad = tmp_path / "corda_tpu_torch" / "node" / "x.py"
        bad.parent.mkdir(parents=True)
        bad.write_text(TestNoSilentExcept.VIOLATION)
        rc = cli_main(["--json", "--no-baseline", str(bad)])
        doc = json.loads(capsys.readouterr().out)
        assert rc == 1
        assert doc["clean"] is False
        assert doc["findings"][0]["rule"] == "no-silent-except"
        assert doc["findings"][0]["line"] == 4
        assert doc["findings"][0]["path"] == "corda_tpu_torch/node/x.py"

        good = tmp_path / "corda_tpu_torch" / "node" / "y.py"
        good.write_text("x = 1\n")
        rc = cli_main(["--json", "--no-baseline", str(good)])
        doc = json.loads(capsys.readouterr().out)
        assert rc == 0
        assert doc["clean"] is True

    def test_no_scannable_path_exits_two(self, tmp_path, capsys):
        assert cli_main([str(tmp_path / "missing")]) == 2

    def test_write_baseline_then_scan_is_clean(self, tmp_path, capsys):
        bad = tmp_path / "corda_tpu_torch" / "node" / "x.py"
        bad.parent.mkdir(parents=True)
        bad.write_text(TestNoSilentExcept.VIOLATION)
        base = tmp_path / "baseline.json"
        assert cli_main(["--baseline", str(base), "--write-baseline",
                         "accepted for the test", str(bad)]) == 0
        entries = load_baseline(base)
        assert [e["path"] for e in entries] == ["corda_tpu_torch/node/x.py"]
        assert cli_main(["--baseline", str(base), str(bad)]) == 0

    def test_list_rules_names_all_six(self, capsys):
        assert cli_main(["--list-rules"]) == 0
        out = capsys.readouterr().out
        for rule in ALL_RULES:
            assert rule.name in out
        assert len(ALL_RULES) >= 6

    def test_rules_keep_the_references_names(self):
        from corda_tpu.analysis import ALL_RULES as REF_RULES

        assert [r.name for r in ALL_RULES] == [r.name for r in REF_RULES]

    def test_bench_report_stamp_is_zero(self):
        report = analyze_paths([TREE])
        assert len(report.findings) == 0
