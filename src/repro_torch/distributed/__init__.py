"""Distributed training helpers, the port's copy of ``repro.distributed``:
int8 gradient compression with error feedback (``compression``) and the
fault-tolerance controller (``fault_tolerance``, a verbatim copy)."""
