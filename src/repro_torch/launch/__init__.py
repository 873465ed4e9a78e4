"""Launchers of the port: training (``train``, its step in ``steps``)
and serving (``serve``)."""
