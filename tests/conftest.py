"""Suite-wide fixtures.

The one below works around a native crash in the pinned jaxlib: once a
single CPU-client process has accumulated roughly 125 live compiled
programs, the next XLA ``backend_compile`` segfaults (no Python
traceback; faulthandler shows the main thread inside
``jax/_src/compiler.py:backend_compile``).  The full suite compiles well
past that across its ~20 modules, so whichever compile-heavy test file
runs around the threshold took the whole session down — historically
``test_conformance.py``'s sweeps (see the quarantine note there), but
the crash site just moves when any one test is isolated.  Dropping every
jit/pjit cache at module boundaries releases the finished modules'
executables and keeps the live-program count bounded for the whole run,
at the cost of re-tracing shared helpers in later modules.
"""
import pytest


def pytest_configure(config):
    # no pytest.ini/pyproject in this repo, so the marker registers here.
    # `tools/ci.sh --fast` deselects `slow` (the inline dist/serve smokes)
    # to keep a sub-5-minute local gate; bare `python -m pytest -x -q`
    # remains the full tier-1 run.
    config.addinivalue_line(
        "markers", "slow: multi-process / serving smokes skipped by ci.sh --fast"
    )
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips on CPU-only machines"
    )


@pytest.fixture(autouse=True, scope="module")
def _bound_live_xla_programs():
    yield
    import jax

    jax.clear_caches()
