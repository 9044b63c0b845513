"""Panel manager: fragments handed back to host seeding (a capacity
overflow, FragmentPanelManager.stats["fallback"]), per search."""


def read(t):
    stats = [s["stats"] for s in t.searches if s["stats"]]
    if not stats:
        return None
    return sum(s.get("fallback", 0) for s in stats) / len(stats)
