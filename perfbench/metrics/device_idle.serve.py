"""The device's idle share of the traced window, in %: one minus the union
of every device operation's interval over the traced wall."""


def read(t):
    if t["unit"] != "pair" or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
