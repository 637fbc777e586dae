"""ops/pyramid.py (grid subsampling and the 9 tiled searches, K1), with the
pair's batch made and uploaded before it: host ms a pair of the pyramid
stage of the program's own entry (register_pair / train_step), each boundary
marked by a forward hook or a wrapper that syncs the device (the traced
run's marked units)."""


def read(t):
    if t["unit"] != "pair":
        return None
    return t["spans_ms"].get("pyramid")
