"""The benchmark's own tests. ``cuda``: needs a CUDA card, decided inside
the test (``pytest.skip``)."""


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'cuda: needs a CUDA card; skips without one')
