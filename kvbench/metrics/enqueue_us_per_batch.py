"""Host microseconds inside ``resolve_group_wire_begin`` a batch (the
native id-encode, the dictionary, the upload and the launches), from
the harness's own spans around each call over the measured window."""


def read(run):
    if not run.groups:
        return None
    host = sum(g.t_ret - g.t_sub for g in run.groups)
    return host / run.batches * 1e6
