"""losses.py: host ms a step of the loss stage of the program's own entry
(register_pair / train_step), each boundary marked by a forward hook or a
wrapper that syncs the device (the traced run's marked units)."""


def read(t):
    if t["unit"] != "step":
        return None
    return t["spans_ms"].get("loss")
