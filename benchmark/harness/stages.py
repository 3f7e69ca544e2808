"""What the per-layer readers take from the program's own stages
(`utils.hostsync.stage`) in `ctx["stages"]`, per frame over the window's
frames before the profiled stretch.  A stage the program never entered there
(a program without it) gives None."""


def self_ms(ctx, label: str):
    """Host milliseconds per frame in the stage `label` less those of the
    stages nested in it."""
    found = ctx["stages"].get(label)
    return None if found is None or "self_s" not in found else found["self_s"] * 1e3


def reads(ctx, labels: tuple):
    """Blocking host reads per frame booked under the stages `labels` (a read
    goes to the innermost open stage only)."""
    found = [ctx["stages"][s]["syncs"] for s in labels if s in ctx["stages"]]
    return sum(found) if found else None
