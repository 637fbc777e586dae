"""The whole unit's share of the card's TF32 peak, in %: the algorithm's
operations a unit (counted from shapes, perfbench/counts/work.py) times
the units a second of the timed window, over 495 TFLOP/s."""


def read(t):
    if t["unit"] != "step" or not t.get("unit_rate"):
        return None
    return 100.0 * t["flops"]["total"] * t["unit_rate"] / t["flops_peak"]
