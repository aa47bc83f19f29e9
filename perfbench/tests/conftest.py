"""Registers the marker of the benchmark's tests that need the card; each
such test decides inside itself whether a card is present."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU; skips (with a reason) where none is present")
