"""Mean time of ``OSDMapMapping``'s fix-up stages a pool update over the
window (the ``fixup_stages`` time counter of osd/mapping.py; the
download of the results is inside it)."""


def read(run):
    f = getattr(run, "fixup", None)
    if not f or not f["count"]:
        return None
    return f["sum"] / f["count"] * 1e3
