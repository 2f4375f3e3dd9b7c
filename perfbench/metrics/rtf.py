"""rtf: the window's wall seconds over the model seconds simulated in it
(the paper's real-time factor; below 1 is faster than real time)."""


def read(record):
    w = record["window"]
    return w["window_s"] / w["model_s"] if w["model_s"] else None
