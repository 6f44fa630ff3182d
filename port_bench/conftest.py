"""pytest settings of the benchmark's own tests (``port_bench/tests``)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; run on the card with "
        "`python3 -m pytest port_bench/tests -m card`, skipped without one")
