"""Host loop: worker-thread milliseconds in the native fragment contexts
(load and index), per Mb of database searched in the window."""


def read(t):
    sec = t.split.spans.get("fragment context", [0.0, 0])[0]
    return 1e3 * sec / t.mb if sec > 0 and t.mb > 0 else None
