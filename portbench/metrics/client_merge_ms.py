"""``client_merge_ms``: the client's deserialize, merge and finalize wall
(``RPC.last_call_client_merge_s``), mean over the window's answered
queries, in ms.  Layer: the client (``rpc``, ``parallel/hostmerge``)."""


def read(window):
    merges = [r["merge_s"] for r in window.records if r["ok"]]
    if not merges:
        return None
    return 1e3 * sum(merges) / len(merges)
