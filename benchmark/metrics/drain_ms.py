"""Host loop, per search: main-thread milliseconds in engine.drain (the
main thread waiting for a worker's result before it queues further
steps), the mean over the window's searches; the program's own span."""

import progtrace


def read(t):
    return progtrace.mean_ms(t, "engine.drain", main=True)
