"""The device's idle share of the traced window, in %: 1 - (the union of
the program's device operation intervals, from ``torch.profiler``'s trace,
over the window).  The benchmark's own digests run on a stream of their
own and are left out."""


def read(run):
    d = run["device"]
    if d is None or d["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - d["program_busy_s"] / d["window_s"])
