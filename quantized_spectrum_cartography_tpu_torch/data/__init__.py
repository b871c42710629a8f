"""Problem container (port of the part of ``data/fixtures.py`` the simulator uses)."""
