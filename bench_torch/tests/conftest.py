"""The harness's own tests (CPU; the ``cuda`` ones need the card):
``python -m pytest bench_torch/tests -q`` from the repository's root."""


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skips "
                                       "without one)")
