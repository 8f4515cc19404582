"""The training loader's consumer time blocked on the decode, in % of the
window: ``LoaderStats.decode_wait_seconds``' growth over the window."""


def read(run):
    s = run["layer"].get("loader")
    if not s or run["window_s"] <= 0:
        return None
    return 100.0 * s["decode_wait_seconds"] / run["window_s"]
