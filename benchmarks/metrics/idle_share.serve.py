"""Share of the serving window in which the card ran no kernel, copy or
memset (profiler trace)."""


def read(rec, ctx):
    t = rec.get("trace")
    if not t or rec["kind"] != "serve":
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
