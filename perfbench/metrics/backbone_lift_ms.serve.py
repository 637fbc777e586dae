"""models/lift.py + models/resunet.py (the color model's 2D backbone and lift):
host ms a pair of the backbone_lift stage of the program's own entry
(register_pair / train_step), each boundary marked by a forward hook or a
wrapper that syncs the device (the traced run's marked units)."""


def read(t):
    if t["unit"] != "pair":
        return None
    return t["spans_ms"].get("backbone_lift")
