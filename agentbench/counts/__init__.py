"""The yardstick's arithmetic: the card's peaks, and for each kernel of
the program a file ``<kernel>.py`` that gives

    NAMES                  substrings of its entries' names in a trace
    calls(call, model)     the launches one model call makes, as shapes
    work(shape)            (operations, bytes) one launch needs

A model call is a dict the traced run records around the model's
``prefill`` and ``decode_step``: ``kind`` ("prefill", "decode", or
"suffix" for a prefix hit's one-row decode), ``S`` (a prefill's tokens),
``rows`` and ``lengths`` (a decode's rows and the valid cache entries of
each, 0 for an idle row).  Bytes count each input read once and each
output written once; operations are multiply-adds times two.  Copied from
the program's own counting (``chip_smoke.py``'s bounds and
``analysis/op_stats.py``) and frozen here: the program may change, the
yardstick may not.
"""
import importlib


def kernel(name: str):
    """The counting module of kernel ``name``."""
    return importlib.import_module(f"agentbench.counts.{name}")
