"""Endpoint rows the dictionary shipped to the card (endpoints not yet
resident) a txn, from the encoder's per-group count over the measured
window."""


def read(run):
    n = [g.n_upd for g in run.groups]
    if not n or any(x is None for x in n):
        return None
    return sum(n) / run.txns
