"""Host loop: the share of the worker threads' span seconds (handle waits,
fragment contexts, host searches) spent waiting for a device step's
resolve (_BatchHandle.get)."""


def read(t):
    spans = t.split.spans
    wait = spans.get("handle wait", [0.0, 0])[0]
    total = sum(spans.get(n, [0.0, 0])[0]
                for n in ("handle wait", "fragment context", "host search"))
    return 100.0 * wait / total if wait > 0 and total > 0 else None
