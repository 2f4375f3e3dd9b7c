"""session.syncs_per_chunk: the port's ``session.syncs`` counter a chunk
(the synchronises, ``.item()`` and ``.cpu()`` reads of ``Simulator.run``
and the backend's run), over a pass of the mix (``perfbench/program.py``)."""
from perfbench import program


def read(record):
    p = program.of(record)
    return None if p is None else p["counts_per_unit"].get("session.syncs")
