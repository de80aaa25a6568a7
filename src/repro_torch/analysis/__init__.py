"""Counts of the port's steps (``op_stats``), the counterpart of
``repro.analysis``."""
