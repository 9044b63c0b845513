"""Database reader, per search: milliseconds in io.decode (a record parsed
from the file's bytes into base codes, once a record a search), the mean
over the window's searches; the program's own span."""

import progtrace


def read(t):
    return progtrace.mean_ms(t, "io.decode")
