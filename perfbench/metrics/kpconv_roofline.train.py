"""The KPConv calls' share of their roofline, in %: the least time the
card could take for their work (counted from shapes and real counts,
perfbench/counts/work.py) over the device time of the kernels under the
KPConv modules' calls (and, in a step, under their backward)."""


def read(t):
    if t["unit"] != "step":
        return None
    return t.get("kpconv_roofline")
