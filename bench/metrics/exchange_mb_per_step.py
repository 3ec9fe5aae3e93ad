"""Bytes a rank puts on the wire a step, in MB (1e6 B): the port's record
of every collective (``core/collectives.py::record``, the ring factors of
``wire_bytes``) over a stretch of steps after the traced one."""


def read(run):
    w = run.wire_bytes_per_step
    return None if w is None else w / 1e6
