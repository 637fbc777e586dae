"""registration/ (sampling, matching, RANSAC) up to the transform on the host:
host ms a pair of the registration stage of the program's own entry
(register_pair / train_step), each boundary marked by a forward hook or a
wrapper that syncs the device (the traced run's marked units)."""


def read(t):
    if t["unit"] != "pair":
        return None
    return t["spans_ms"].get("registration")
