"""The benchmark's own tests (run from the root of a checkout:
``python -m pytest speedy_bench/tests -q``; on the card with ``-m gpu``)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped without one")
