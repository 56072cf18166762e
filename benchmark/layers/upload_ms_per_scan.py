"""The benchmark's spans around ``lio.build_batches`` of each untraced
chunk of the window (every replica's), each ending in a synchronize, in ms
a scan (host clock)."""


def read(run):
    w = run.window
    return 1e3 * w.upload_s / w.upload_scans if w.upload_scans else None
