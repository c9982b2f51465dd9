"""The share of the window's group dispatches through the endpoint
dictionary whose new endpoints did not ride the group's one fused
upload: groups the backend sent down the lanes path
(``dict_fallbacks``) and groups whose dictionary rows the conflict set
shipped apart (``apply_dict_updates``, counted by the harness)."""


def read(run):
    c = run.counters
    if c.dict_dispatches <= 0:
        return None
    return 100.0 * (c.dict_fallbacks + c.dict_out_of_band) / c.dict_dispatches
