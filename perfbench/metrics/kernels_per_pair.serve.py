"""Device kernels a unit: every kernel the profiler sees in the traced
window (any launch API, the libraries' included), over the units."""


def read(t):
    if t["unit"] != "pair":
        return None
    return t["kernels_per_unit"]
