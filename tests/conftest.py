"""Shared test helpers.

``hypothesis`` is an optional dependency (CI runs a tier-1 job without
it): test modules import ``given``/``settings``/``st`` from here so that
without hypothesis the property-based tests skip cleanly while every
deterministic test still runs.
"""
import pytest

try:
    from hypothesis import given, settings, strategies as st  # noqa: F401
except ImportError:                      # pragma: no cover - optional dep
    def _skip_property_test(*_a, **_k):
        def deco(fn):
            return pytest.mark.skip(
                reason="property tests need hypothesis")(fn)
        return deco
    given = settings = _skip_property_test

    class _AnyStrategy:
        """Chainable stand-in so strategy expressions in decorator
        arguments (st.integers(1, 5).map(...) etc.) evaluate harmlessly
        at collection time."""

        def __getattr__(self, _name):
            return lambda *a, **k: _AnyStrategy()

    st = _AnyStrategy()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips inside the test without "
        "one (run them on the card: python -m pytest -m gpu)")
