"""The Shamir ladder kernel's share of its roofline in the profiled
stretch: the sum, over its launches there, of the least time its IMAD
operations take at the launch's padded rows (``roofline.py``, the published
peak), over the sum of the launches' device time, in percent. A launch's
rows are its grid's blocks times the rows a block holds."""

from cardbench import roofline


def read(record):
    prof = record["profile"]
    launches = [x for x in (prof or {}).get("ladder", []) if x["grid"] and x["s"] > 0]
    if not launches:
        return None
    bound = sum(roofline.bound_s("ladder", x["grid"][0] * roofline.LADDER_ROWS_PER_BLOCK) for x in launches)
    return 100.0 * bound / sum(x["s"] for x in launches)
