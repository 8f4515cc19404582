"""The rows the window completed over its seconds, counted as
``rows_per_s`` counts them, in a cell whose rate spreads from run to run
by more than any bound the benchmark may set, so that it is watched here,
per layer, and not held end to end."""


def read(run):
    rows = run["layer"].get("window_rows")
    if not rows or run["window_s"] <= 0:
        return None
    return rows / run["window_s"]
