"""Host loop: worker-thread milliseconds in host.seed_inject (the device's
seeds and evaluations handed to each fragment context), per Mb of
database searched in the window; the program's own span."""

import progtrace


def read(t):
    return progtrace.ms_per_mb(t, "host.seed_inject")
