"""The share of the window the main thread spent inside the port's
formatter, codec/batch_host._format_batch (the benchmark's span around
each resumption of the module-level call, traced run only)."""


def read(run):
    s = run.spans.get("format")
    return 100.0 * s / run.window_s if s is not None and run.window_s \
        else None
