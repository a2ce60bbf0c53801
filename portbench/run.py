"""The benchmark of lctvqa_torch: one cell of BENCHMARK.json a run.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. It looks the cell up in BENCHMARK.json,
loads its configuration (`portbench/configs/<config>.json`), its traffic
mix (`portbench/traffic/<traffic>.json`, whose "driver" names the general
driver under `portbench/drivers/`), the limits of its correctness
numbers (`portbench/limits/<cell>.json`) and, with `--trace 1`, the
reader of each of its per-layer metrics (`portbench/metrics/<metric>.py`),
all by name. It sets up (the weights and inputs made from `--seed`, every
shape of the cell warmed), measures for `--seconds`, checks what the
timed path produced against the plain reference, and prints one JSON
line last on standard output, each number compared beside its limit as
the last lines on standard error.

Exit codes: 0 a result printed (`correct` may be false); 2 an unknown
name or a malformed file; 3 no card, or fewer than the cell asks for;
4 JAX or the JAX package in the process after the window.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lctvqa")


def _cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout; nothing of the
    environment's JAX."""
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(build / "inductor"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


class Refused(Exception):
    """An unknown name or a malformed benchmark file (exit 2)."""


def load_json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except (OSError, ValueError) as exc:
        raise Refused(f"cannot read {path}: {exc}") from exc


def lookup(bench: dict, cell: str) -> dict:
    """The cell's entry, its configuration, mix, limits, and the metrics it
    reports -> a dict; an unknown name raises Refused naming the known
    ones."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise Refused(f"unknown workload {cell!r}; known: "
                      f"{', '.join(sorted(cells))}")
    w = cells[cell]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise Refused(f"cell {cell!r} names the unknown configuration "
                      f"{w['config']!r}; known: {', '.join(sorted(configs))}")
    mix_path = HERE / "traffic" / f"{w['traffic']}.json"
    if not mix_path.exists():
        known = sorted(p.stem for p in (HERE / "traffic").glob("*.json"))
        raise Refused(f"cell {cell!r} names the unknown traffic mix "
                      f"{w['traffic']!r}; known: {', '.join(known)}")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    for m in layer:
        if not (HERE / "metrics" / f"{m['name']}.py").exists():
            raise Refused(f"no reader portbench/metrics/{m['name']}.py for "
                          f"the per-layer metric {m['name']!r}")
    return {"cell": w, "config": load_json(ROOT / configs[w["config"]]
                                           ["file"]),
            "mix": load_json(mix_path),
            "limits": load_json(HERE / "limits" / f"{cell}.json"),
            "end_to_end": e2e, "per_layer": layer}


def reader(name: str):
    """The `read(run)` of `portbench/metrics/<name>.py`."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver_class(mix: dict):
    name = mix.get("driver", "")
    if not (HERE / "drivers" / f"{name}.py").exists() or name == "serving":
        raise Refused(f"unknown driver {name!r}")
    return importlib.import_module(f"portbench.drivers.{name}").Driver


class Context:
    """What a driver is given: the configuration, the mix, the seed, the
    device, and (for the tests and the calibration alone) a fault to
    plant."""

    def __init__(self, spec: dict, seed: int, device, fault=None):
        self.cell = spec["cell"]
        self.config = spec["config"]
        self.mix = spec["mix"]
        self.seed = seed
        self.device = device
        self.fault = fault


class Run:
    """What a per-layer metric's reader reads: the window's result, its
    host spans and profiled stretch, the launches' shapes, the model's
    sizes."""

    def __init__(self, ctx, window: dict, tracer, shapes):
        self.window, self.tracer, self.shapes = window, tracer, shapes
        self.model = ctx.config["model"]

    @property
    def profile(self):
        return self.tracer.profile


class ShapeLog:
    """The shapes of each launch of the kernels whose rooflines are read,
    taken at the port's entry points while a stretch is profiled."""

    def __init__(self, tracer):
        self.tracer = tracer
        self.node, self.bn, self.decode = [], [], []
        self._undo = []

    def install(self) -> None:
        import torch
        from lctvqa_torch.ops import cuda_bn, cuda_generate, cuda_mixedop

        def grad_of(ts):
            return torch.is_grad_enabled() and any(t.requires_grad
                                                   for t in ts)

        def node(fn):
            def wrapped(xs, p_list, weights, cs):
                if self.tracer.profiling:
                    n, h, w = xs[0].shape[:3]
                    self.node.append((n, h, w, cs, len(xs),
                                      str(xs[0].dtype).split(".")[-1],
                                      grad_of(list(xs) + [weights])))
                return fn(xs, p_list, weights, cs)
            return wrapped

        def bn(fn):
            def wrapped(x, out_dtype=None, *a, **k):
                if self.tracer.profiling:
                    self.bn.append((x.numel(), str(x.dtype).split(".")[-1],
                                    str(out_dtype or torch.float32)
                                    .split(".")[-1], grad_of([x])))
                return fn(x, out_dtype, *a, **k)
            return wrapped

        def dec(fn):
            def wrapped(params, image_embedding, max_length, *a, **k):
                if self.tracer.profiling:
                    dt = k.get("dtype", a[0] if a else None)
                    self.decode.append((image_embedding.shape[0], max_length,
                                        str(dt or torch.float32)
                                        .split(".")[-1]))
                return fn(params, image_embedding, max_length, *a, **k)
            return wrapped

        for mod, name, wrap in ((cuda_mixedop, "mixed_node", node),
                                (cuda_bn, "batchnorm_fwd", bn),
                                (cuda_generate, "greedy_generate", dec)):
            orig = getattr(mod, name)
            self._undo.append((mod, name, orig))
            setattr(mod, name, wrap(orig))

    def remove(self) -> None:
        for mod, name, orig in self._undo:
            setattr(mod, name, orig)
        self._undo = []


def release_memory(device) -> None:
    import gc

    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def numbers_line(numbers: dict, limits: dict) -> dict:
    return {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}


def judge(numbers: dict, limits: dict) -> bool:
    missing = set(numbers) ^ set(limits)
    if missing:
        raise Refused(f"the limits file and the check differ on "
                      f"{sorted(missing)}")
    return all(v <= limits[k] for k, v in numbers.items())


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(spec: dict, seed: int, seconds: float, trace: bool, device,
            fault=None, t_start: float = None) -> dict:
    """Set-up, window, check -> the result dict (and the numbers compared
    under "checks"). `device` is the card, or the CPU where a test drives
    the run at a size the CPU holds."""
    import torch

    from portbench.harness import Tracer

    t_start = time.perf_counter() if t_start is None else t_start
    ctx = Context(spec, seed, device, fault)
    drv = driver_class(spec["mix"])(ctx)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    drv.setup()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    mix = spec["mix"]
    tracer = Tracer(False, device=device)
    window = drv.window(seconds, tracer)
    if trace:
        # a stretch profiled after the window: the profiler's set-up and
        # CUPTI's cost a launch, which stays once it has run, would slow
        # the window that the host-side metrics read
        stretch = Tracer(True, start=mix.get("trace_start", 2),
                         units=mix.get("trace_units", 3), device=device)
        stretch.warm()
        shapes = ShapeLog(stretch)
        shapes.install()
        try:
            drv.window(mix.get("trace_seconds", 0.0), stretch)
        finally:
            shapes.remove()
        tracer.profiles = stretch.profiles
    else:
        shapes = ShapeLog(tracer)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run = Run(ctx, window, tracer, shapes)
    metrics = {}
    if trace:
        if tracer.profile is None:
            raise RuntimeError("the traced run profiled no stretch")
        for m in spec["per_layer"]:
            v = reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            v = (setup_s if m["name"] == "setup_s"
                 else window["values"].get(m["name"]))
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    drv.release()
    numbers = drv.check()
    limits = spec["limits"]["numbers"]
    result = {"correct": judge(numbers, limits) and window["failed"] == 0,
              "attempted": window["attempted"], "failed": window["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": (torch.cuda.get_device_name(device)
                                  if cuda else "cpu"),
                         "count": spec["cell"]["chips"],
                         "memory_peak_bytes": int(peak)}}
    if trace:
        p = tracer.profile
        result["device"].update(busy_s=p.busy_s, window_s=p.window_s)
        result["breakdown"] = {"device_ops": p.top_ops(),
                               "idle_gaps": p.idle_gaps()}
    result["checks"] = numbers_line(numbers, limits)
    return result


def main(argv=None) -> int:
    _cache_dirs()
    args = parse(argv)
    try:
        spec = lookup(load_json(ROOT / "BENCHMARK.json"), args.workload)
        driver_class(spec["mix"])
    except (Refused, KeyError) as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    import torch

    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell asks for {chips} card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    result = execute(spec, args.seed, args.seconds, bool(args.trace), device,
                     t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process holds {', '.join(found)} after the "
              "window", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"portbench: check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
