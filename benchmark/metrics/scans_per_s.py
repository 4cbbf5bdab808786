"""Scans answered in the window over the window's seconds; the inserts'
time and everything between calls stay in the window."""


def read(run):
    return run.done.get("scan", 0) / run.window_s
