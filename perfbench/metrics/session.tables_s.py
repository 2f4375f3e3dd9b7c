"""session.tables_s: seconds of the port's ``session.build.tables`` span,
the delivery strategy's tables (its padded host arrays and their upload),
in a session built like the run's own under the port's recording
(``perfbench/program.py``)."""
from perfbench import program


def read(record):
    p = program.of(record)
    return None if p is None else p["build_s"].get("session.build.tables")
