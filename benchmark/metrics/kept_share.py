"""Panel manager: kept windows over the candidates the device step seeded
(FragmentPanelManager.stats), over the window's searches."""


def read(t):
    stats = [s["stats"] for s in t.searches if s["stats"]]
    seeds = sum(s.get("seeds", 0) for s in stats)
    kept = sum(s.get("kept", 0) for s in stats)
    return 100.0 * kept / seeds if seeds else None
