"""``segment_hist``'s share of its roofline over the window: the least time
the card could take for the pair occurrences and distinct pairs it counts
(``peaks.segment_hist_bound_s``; with a FREQ-SPLIT head, the pairs whose
higher term lies past it), over the kernel's device time."""

from yardstick import peaks
from yardstick import trace as T


def read(ctx):
    if "jobs" not in ctx:
        return None
    device_s = T.op_seconds(ctx["ops"], "segment_hist")
    if device_s <= 0:
        return None
    bound = sum(peaks.segment_hist_bound_s(j["tail_occurrences"], j["tail_distinct"])
                for j in ctx["jobs"])
    return 100.0 * bound / device_s
