"""Seconds of 16 kHz audio of all streams read back to the host in the
window, over the window's seconds (host clock)."""


def read(rec, ctx):
    if rec["kind"] != "serve":
        return None
    return rec["audio_s"] / rec["window_s"]
