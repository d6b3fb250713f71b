"""Command-line entry points of the port: ``serve`` (the twin of
``repro.launch.serve`` on its single-device path) and ``train`` (the twin
of ``repro.launch.train``)."""
