"""The readings that a cell's correctness limits are set from, on the
card, in one process (the benchmark's own runs never run this):

    python3 -m portbench.calibrate --workload <cell> --seeds <n>... \
        [--controls <n>...] [--faults frozen,half_batch,token] \
        [--fault-seeds <n>...] [--seconds 2] [--out FILE]

- the program's numbers on each of `--seeds` (the lower reading is their
  largest);
- the control's on each of `--controls`: where the program has a path in
  the precision below the configuration's (the W answerer's int8), the
  program with it on; otherwise the plain reference with its products'
  operands in float8 in the program's place. For training it also reads
  the reference in bfloat16, the configuration's own precision, against
  the exact one: a second witness of what rounding alone reads;
- each planted fault's on each of `--fault-seeds`.

A serving cell runs a window of `--seconds` at its own load so that its
sample of calls fills; training needs none. Each reading is one JSON
line on standard output and, with `--out`, in that file.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import run as B
from portbench.harness import Tracer
from portbench.reference import model as R


def readings(spec, seed, device, seconds, fault=None, extra=()):
    drv = B.driver_class(spec["mix"])(B.Context(spec, seed, device, fault))
    t0 = time.perf_counter()
    drv.setup()
    if drv.unit != "step":
        drv.window(seconds, Tracer(False))
    drv.release()
    out = {"numbers": drv.check(), "setup_s": time.perf_counter() - t0}
    for name in extra:
        out[name] = globals()[f"_{name}"](drv)
    del drv
    B.release_memory(device)
    return out


def _control(drv):
    if drv.unit == "step":
        from portbench.drivers.train import compare
        ctl = drv.reference(R.Numerics("fp8"))
        return compare(ctl, drv.reference(R.EXACT, pseudo=ctl["pseudo"]))
    return drv.control()


def _witness_bf16(drv):
    from portbench.drivers.train import compare
    return compare(drv.reference(R.Numerics("bf16"), pseudo=drv.pseudo),
                   drv.reference(R.EXACT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--controls", type=int, nargs="*", default=[])
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    a = p.parse_args(argv)
    B._cache_dirs()
    spec = B.lookup(B.load_json(B.ROOT / "BENCHMARK.json"), a.workload)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = open(a.out, "a") if a.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in a.seeds:
        emit({"cell": a.workload, "kind": "program", "seed": seed,
              **readings(spec, seed, device, a.seconds)})
    for seed in a.controls:
        if spec["mix"]["driver"] in ("answer", "serve"):
            # the program's own int8 path, and the float8 reference
            emit({"cell": a.workload, "kind": "control_int8", "seed": seed,
                  **readings(spec, seed, device, a.seconds, fault="int8")})
        if spec["mix"]["driver"] == "serve":
            continue
        extra = (("control", "witness_bf16")
                 if spec["mix"]["driver"] == "train" else ("control",))
        emit({"cell": a.workload, "kind": "control", "seed": seed,
              **readings(spec, seed, device, a.seconds, extra=extra)})
    for fault in filter(None, a.faults.split(",")):
        for seed in a.fault_seeds:
            emit({"cell": a.workload, "kind": f"fault_{fault}", "seed": seed,
                  **readings(spec, seed, device, a.seconds, fault=fault)})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
