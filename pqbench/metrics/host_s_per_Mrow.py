"""Host phase seconds per million rows: ``ReaderStats.host_seconds`` (read,
decompress, page and run walks, ship planning) summed over the window's
complete passes, over their rows."""


def read(run):
    r = run["layer"].get("reader")
    if not r or not r["rows"]:
        return None
    return r["host_seconds"] / (r["rows"] / 1e6)
