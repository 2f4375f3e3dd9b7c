"""chunk_p95_ms: the 95th percentile, over every unit of the window, of
the wall time from asking for a unit to holding its counts on the host."""
import numpy as np


def read(record):
    walls = record["window"]["unit_walls_s"]
    return float(np.percentile(walls, 95)) * 1e3 if walls else None
