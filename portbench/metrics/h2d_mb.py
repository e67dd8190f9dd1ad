"""``h2d_mb``: the bytes the worker's uploads copied to the card for a
query: the ``bytes`` tags of its ``h2d_transfer`` spans (the layout's
codes and value columns) and of its ``filter`` spans (the mask's
columns), summed in its autopsy's ``tagged``; 0 where the working set held
every block.  Mean over the autopsies of the window's last queries, in MB
(1e6 bytes).  Layer: the worker and its executor (``parallel/executor``,
``ops/workingset``).  Nothing to read off a card (no traced device), or
where the program tags no bytes."""

SEGMENTS = ("h2d_transfer", "filter")


def read(window):
    if not window.device or not window.autopsies:
        return None
    tagged = [a.get("tagged") for a in window.autopsies]
    if not any(tagged):
        return None
    total = sum(float(t.get(s, {}).get("bytes", 0))
                for t in tagged if t for s in SEGMENTS)
    return total / 1e6 / len(window.autopsies)
