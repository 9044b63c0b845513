"""Database reader, per search: milliseconds in io.open (the database
file read whole and its records indexed, their count and fragments), the
mean over the window's searches; the program's own span."""

import progtrace


def read(t):
    return progtrace.mean_ms(t, "io.open")
