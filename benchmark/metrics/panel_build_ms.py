"""Panel manager, per search: milliseconds in panel.build (the
FragmentPanelManager: the screen's tables and the panel groups), the mean
over the window's searches; the program's own span."""

import progtrace


def read(t):
    return progtrace.mean_ms(t, "panel.build")
