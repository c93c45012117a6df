"""Test configuration: run the suite on a virtual 8-device CPU mesh, with a
time limit on every test.

Multi-chip sharding is validated on faked CPU devices per SURVEY.md §4
("multi-node testing"); the real-TPU path is exercised by bench.py and the
driver's compile checks.
"""

import faulthandler
import os
import signal
import tempfile
import time

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ.setdefault("BN_TPU_BACKEND", "jnp")

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache: XLA:CPU compiles these integer graphs slowly
# (~500 HLO/s); caching makes repeat test runs fast.  It lives under the
# temporary directory (TMPDIR), so two checkouts run with their own TMPDIR
# share nothing, and has one directory for each xdist worker: processes
# writing one directory at once have crashed in the cache's writes.
jax.config.update(
    "jax_compilation_cache_dir",
    os.path.join(tempfile.gettempdir(), "bn_tpu_jax_cache", os.environ.get("PYTEST_XDIST_WORKER", "main")),
)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

jax.config.update("jax_persistent_cache_enable_xla_caches", "none")

# Seconds that a test may take, setup, call and teardown together.  The
# longest port test in cold runs of the whole suite on six workers is
# test_torch_dist.py's comparison with the JAX package's sharded_msm, whose
# multi-threaded compile took 302-482 s in eleven such runs on 8 cores and
# would take about 650 s in a run as much slower as such a box has given:
# the limit is about 1.4x that.  A test that needs longer is marked slow, or
# is a defect.
LIMIT = 900
# Seconds a teardown gets even past the deadline, so that a test that ran out
# still cleans up; and seconds past its alarm after which faulthandler ends a
# process whose phase hangs inside C code that never returns to Python.
GRACE = 60

_DEADLINE = pytest.StashKey[float]()


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item):
    """One deadline for the whole test: LIMIT seconds from its start."""
    item.stash[_DEADLINE] = time.monotonic() + LIMIT
    yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_setup(item):
    yield from _within_deadline(item, 1e-3)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    yield from _within_deadline(item, 1e-3)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_teardown(item):
    yield from _within_deadline(item, GRACE)


def _within_deadline(item, at_least):
    """Run one phase of `item` until the test's deadline, or for `at_least`
    seconds if that is later, then fail it with pytest.fail from SIGALRM (so
    the caller must be the main thread); GRACE seconds later faulthandler
    dumps the stacks and exits the process.  Both are disarmed between
    phases, so pytest reports the failure as the phase's."""

    def expire(signum, frame):
        pytest.fail(f"{item.nodeid} ran past the per-test limit of {LIMIT} s", pytrace=False)

    left = max(item.stash[_DEADLINE] - time.monotonic(), at_least)
    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, left)
    faulthandler.dump_traceback_later(left + GRACE, exit=True)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, previous)


def pytest_collection_modifyitems(items):
    """Run the port's tests (tests/test_torch_*.py) before the JAX package's:
    several of them are among the suite's longest, so starting them first
    keeps them off the run's tail."""
    items.sort(key=lambda item: not item.path.name.startswith("test_torch_"))
