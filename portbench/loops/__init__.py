"""The general loops, one file a ``kind`` of traffic mix; the harness loads
``<kind>.py`` by its path and calls its ``run``."""
