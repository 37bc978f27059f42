"""idle_share.serve: 1 - the union of the device's busy intervals over the
traced window, in %. Read in the denoise cells."""


def read(t):
    if not t or t.get("kind") != "serve":
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
