"""Stand-alone measurement entry points of the port (run with `python -m`)."""
