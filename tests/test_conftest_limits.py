"""The suite's own limits (tests/conftest.py): the per-test time limit, one
deadline for a test's setup, call and teardown together, and the `slow`
marker that the default run leaves out.

The limit is checked on inner tests run in this process through pytester,
with conftest.py as their plugin and its LIMIT patched to a second or two.
"""

import signal

import conftest

pytest_plugins = ["pytester"]


def test_sleep_past_the_limit_fails_with_its_message(pytester, monkeypatch):
    monkeypatch.setattr(conftest, "LIMIT", 1)
    pytester.makepyfile("import time\n\ndef test_sleeps():\n    time.sleep(30)\n")
    result = pytester.runpytest_inprocess(plugins=[conftest])
    result.assert_outcomes(failed=1)
    result.stdout.fnmatch_lines(["*test_sleeps ran past the per-test limit of 1 s*"])
    assert result.duration < 20


def test_setup_and_call_share_one_limit(pytester, monkeypatch):
    """Setup and call each take less than the limit, together more: the call
    fails, and the teardown, which starts past the deadline, still runs."""
    monkeypatch.setattr(conftest, "LIMIT", 2)
    pytester.makepyfile(
        "import time\n\nimport pytest\n\n"
        "@pytest.fixture\ndef slow_setup():\n    time.sleep(1.2)\n    yield\n    time.sleep(0.5)\n\n"
        "def test_sleeps(slow_setup):\n    time.sleep(1.2)\n"
    )
    result = pytester.runpytest_inprocess(plugins=[conftest])
    result.assert_outcomes(failed=1)
    result.stdout.fnmatch_lines(["*test_sleeps ran past the per-test limit of 2 s*"])


def test_no_timer_left_armed_after_a_passing_test(pytester, monkeypatch):
    monkeypatch.setattr(conftest, "LIMIT", 5)
    pytester.makepyfile("def test_passes():\n    assert True\n")
    result = pytester.runpytest_inprocess(plugins=[conftest])
    result.assert_outcomes(passed=1)
    assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)


def test_slow_marker_is_registered(pytestconfig):
    assert any(m.split(":")[0].strip() == "slow" for m in pytestconfig.getini("markers"))
