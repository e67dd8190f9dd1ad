"""``bundle_members``: how many queries the scan that computed a query
served, mean over the autopsies (``rpc.autopsy``) of the window's last
queries.  A query the micro-batch window staged into a dispatch that the
worker ran as one ``execute_bundle`` (its autopsy's ``batch.shared_scan``)
counts that dispatch's ``batch.members``; a query that launched alone, or
whose bundle ran member by member, counts 1.  Layer: the controller
(``controller``, ``plan/bundle``).  Nothing to read where no autopsy
carries ``batch`` (a window of 0, or a program that does not record it)."""


def read(window):
    batches = [a.get("batch") for a in window.autopsies]
    if not any(isinstance(b, dict) for b in batches):
        return None
    total = sum(float(b.get("members") or 1)
                if isinstance(b, dict) and b.get("shared_scan") else 1.0
                for b in batches)
    return total / len(batches)
