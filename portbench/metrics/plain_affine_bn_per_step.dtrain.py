"""Affine BatchNorm calls a step that take the plain route (the
program's counter `bn.plain_affine` in `ops/conv.py::batchnorm`), over
the window's steps; None where the program counts no such route."""


def read(run):
    prog = run.window.get("program") or {}
    n = prog.get("counts", {}).get("bn.plain_affine")
    units = run.window.get("units")
    return n / units if n is not None and units else None
