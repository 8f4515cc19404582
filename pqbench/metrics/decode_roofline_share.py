"""The decode's share of its bandwidth bound, in %.

The work is what a decode has to move in device memory to return what the
program returns, counted from the file and the program's output form: the
uncompressed bytes of every column chunk the window's row groups read,
read once (the host expands the pages before they cross, or the card
expands them, which writes as much), plus the bytes of the columns written
once (a fixed-width or PLAIN string column's values as the reference
counts them; a column returned as a dictionary, its indices and dictionary
tables; a leaf with levels, besides, one byte a slot for each level stream
it has, the least any decode writes).  That total at the card's peak
bandwidth is the bound; the share is the bound over the device busy time
of the program's operations in the window (the union of their kernel, copy
and set intervals in ``torch.profiler``'s trace, host-to-device copies
included; the benchmark's own digests and gathers run on a stream left
out)."""


def read(run):
    b = run["layer"].get("decode_bytes")
    if run["device"] is None or not b or not (b["read"] + b["written"]):
        return None
    busy = run["device"]["program_busy_s"]
    if busy <= 0:
        return None
    bound = (b["read"] + b["written"]) / run["peak_bytes_per_s"]
    return 100.0 * bound / busy
