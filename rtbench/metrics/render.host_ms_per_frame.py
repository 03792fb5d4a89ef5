"""The host's time to enqueue a frame: the benchmark's span around
``Renderer.update`` (no sync), averaged over the traced sub-window's frames."""


def read(run):
    ms = run.window.get("traced_host_ms") or []
    return sum(ms) / len(ms) if ms else None
