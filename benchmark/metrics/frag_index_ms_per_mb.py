"""Host loop: worker-thread milliseconds in host.frag_index (the native
fragment index of each fragment context), per Mb of database searched in
the window; the program's own span."""

import progtrace


def read(t):
    return progtrace.ms_per_mb(t, "host.frag_index")
