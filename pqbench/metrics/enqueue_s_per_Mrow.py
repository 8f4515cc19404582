"""Staging and dispatch enqueue seconds per million rows:
``ReaderStats.stage_seconds`` + ``dispatch_seconds`` over the window's
complete passes.  Host clocks around the enqueue of copies and launches,
not device times."""


def read(run):
    r = run["layer"].get("reader")
    if not r or not r["rows"]:
        return None
    return (r["stage_seconds"] + r["dispatch_seconds"]) / (r["rows"] / 1e6)
