"""`frame_ms`: the window's length over the frames whose results reached the
host inside it (the inverse of the frame rate the system keeps up with)."""


def read(run):
    n = len(run.window.counted())
    return run.window.seconds * 1e3 / n if n else None
