"""bench.py driver hardening: partial-result harvesting, SIGTERM-with-grace
child control, and the selftest gate. These are the mechanisms that keep the
driver artifact non-empty when a workload times out, and keep it from
claiming a result on an unproven device."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bench  # noqa: E402  (repo-root module)


def test_run_child_sigterm_grace_captures_output():
    # a child that overruns gets SIGTERM + grace, and the stdout it already
    # flushed is captured (not lost to a SIGKILL). The timeout leaves
    # margin for interpreter startup, so the print happens at all.
    code = "import time\nprint('banked-line', flush=True)\ntime.sleep(60)\n"
    so, rc, timed_out, _se = bench._run_child(code, timeout_s=10)
    assert timed_out is True
    assert "banked-line" in so


def test_run_child_normal_completion():
    so, rc, timed_out, _se = bench._run_child(
        "print('done', flush=True)\n", timeout_s=30)
    assert timed_out is False and rc == 0 and "done" in so


def test_run_workload_harvests_last_partial(monkeypatch):
    # a body that streams stage partials behind the MARKER and then dies
    # still yields the LAST partial (the shard-model progress contract)
    monkeypatch.setattr(bench, "_t0", __import__("time").monotonic())
    body = ("_partial({'stage': 1})\n"
            "_partial({'stage': 2})\n"
            "raise RuntimeError('stage 3 blew up')\n"
            "r = {'never': 'reached'}\n")
    r = bench.run_workload("partial-test", body, timeout_s=120)
    assert r is not None and r["stage"] == 2
    assert "device" in r


def test_run_workload_full_result_wins(monkeypatch):
    monkeypatch.setattr(bench, "_t0", __import__("time").monotonic())
    body = "_partial({'stage': 1})\nr = {'stage': 'final'}\n"
    r = bench.run_workload("full-test", body, timeout_s=120)
    assert r is not None and r["stage"] == "final"


def test_gate_timeout_is_fatal(monkeypatch, capsys):
    # a selftest gate that does not finish fails the bench: no perf lines
    # from a device whose results were never checked
    monkeypatch.setattr(bench, "_t0", __import__("time").monotonic())
    monkeypatch.delenv("ZOTPU_BENCH_GATE", raising=False)
    monkeypatch.setattr(bench, "_run_child",
                        lambda code, timeout_s: ("", None, True, ""))
    monkeypatch.setattr(bench, "_records", [])
    assert bench.run_gate() is False
    assert bench._records[-1]["metric"] == "selftest_failed"
