"""Every output token the engine emitted inside the window, over the
window's seconds (tokens/s)."""


def read(record):
    w = record["window"]
    return w["tokens"] / w["seconds"] if w["tokens"] else None
