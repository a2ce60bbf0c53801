"""Host milliseconds a step in the program's span `ef.trunk` (the derived
EF's image encoder, in stage 1's forward and stage 2's generation), from
the program's table over the window's steps; None where the program has
no such span."""


def read(run):
    prog = run.window.get("program") or {}
    total = prog.get("totals", {}).get("ef.trunk")
    units = run.window.get("units")
    return 1e3 * total / units if total is not None and units else None
