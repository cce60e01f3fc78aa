"""Command-line tools built on the port: inverse rendering (``fit_scene``)."""
