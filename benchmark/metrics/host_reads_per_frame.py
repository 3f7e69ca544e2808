"""`host_reads_per_frame`: blocking device-to-host reads per frame, the
program's own count (`utils.hostsync.COUNTS["syncs"]`), over the window's
frames before the profiled stretch."""


def read(ctx):
    return ctx["reads_per_frame"]
