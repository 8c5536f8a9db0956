"""The card-only marker, for this package's tests."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips inside the test without "
        "one (run them on the card: python -m pytest -m gpu)")
