"""Percent of the profiled stretch in which no operation ran on the card:
one less the union of the device intervals over the stretch's length."""


def read(record):
    prof = record.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
