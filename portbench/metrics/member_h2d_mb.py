"""``member_h2d_mb``: the bytes the worker's uploads copied to the card
for a query, each scan's counted once: the ``bytes`` tags of the
``h2d_transfer`` spans (the layout's codes and value columns) and of the
``filter`` spans (the mask's columns) in its autopsy's ``tagged``, times
its ``bundle.share`` where it rode a bundle (whose spans reach every
member's timeline whole), in full otherwise.  Mean over the autopsies of
the window's last queries, in MB (1e6 bytes).  Layer: the worker and its
executor (``parallel/executor``, ``ops/predicates``, ``ops/workingset``).
Nothing to read off a card (no traced device), or where the program tags
no bytes."""

SEGMENTS = ("h2d_transfer", "filter")


def read(window):
    if not window.device or not window.autopsies:
        return None
    if not any(a.get("tagged") for a in window.autopsies):
        return None
    total = 0.0
    for a in window.autopsies:
        tagged = a.get("tagged") or {}
        bundle = a.get("bundle")
        share = (float(bundle.get("share", 1.0))
                 if isinstance(bundle, dict) else 1.0)
        total += share * sum(float(tagged.get(s, {}).get("bytes", 0))
                             for s in SEGMENTS)
    return total / 1e6 / len(window.autopsies)
