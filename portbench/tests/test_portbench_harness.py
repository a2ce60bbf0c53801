"""The harness finds every cell's configuration, traffic mix, limits,
driver and per-layer readers by name, refuses unknown names (naming the
known ones), and BENCHMARK.json keeps to the benchmark's contract."""

from __future__ import annotations

import copy
import json
import re

import pytest

from portbench import run

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_by_name(cell):
    spec = run.lookup(BENCH, cell)
    assert spec["cell"]["name"] == cell
    assert spec["config"]["name"] == spec["cell"]["config"]
    assert run.driver_class(spec["mix"]).e2e in {
        m["name"] for m in spec["end_to_end"]}
    assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s"}
    assert spec["per_layer"], "a cell reports at least one per-layer metric"
    for m in spec["per_layer"]:
        assert callable(run.reader(m["name"]))
    assert set(spec["limits"]["numbers"]) == set(spec["limits"]["readings"])


def _bench_with(**changes):
    b = copy.deepcopy(BENCH)
    b["workloads"][0].update(changes)
    return b


@pytest.mark.parametrize("bench, needle", [
    (BENCH, "unknown workload 'no_such_cell'; known: ef_generate_224"),
    (_bench_with(name="no_such_cell", traffic="no_such_mix"),
     "unknown traffic mix 'no_such_mix'; known: answer_b64_closed"),
    (_bench_with(name="no_such_cell", config="no_such_config"),
     "unknown configuration 'no_such_config'; known: lct_pcdarts_224"),
])
def test_unknown_names_are_refused(bench, needle):
    with pytest.raises(run.Refused, match=re.escape(needle)):
        run.lookup(bench, "no_such_cell")


def test_unknown_metric_and_driver_are_refused():
    b = copy.deepcopy(BENCH)
    b["per_layer"].append(dict(b["per_layer"][0], name="no_such_metric"))
    with pytest.raises(run.Refused, match="no_such_metric"):
        run.lookup(b, b["per_layer"][0]["workloads"][0])
    with pytest.raises(run.Refused, match="unknown driver 'serving'"):
        run.driver_class({"driver": "serving"})


def test_main_exits_2_on_an_unknown_name_and_3_without_a_card(capsys):
    assert run.main(["--workload", "nope", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert "known: ef_generate_224" in capsys.readouterr().err
    assert run.main(["--workload", "vqa_answer_224", "--seed", "1",
                     "--seconds", "1"]) == 3
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "card" in captured.err


def test_benchmark_json_keeps_to_the_contract():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and NAME.match(c["name"])
        assert run.load_json(run.ROOT / c["file"])["name"] == c["name"]
        assert any(w["config"] == c["name"] for w in b["workloads"])
    cells = {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in names
        names.add(m["name"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(b)) < 64 * 1024


class _Range:
    def __init__(self, a, b):
        self.start, self.end = a, b


class _Event:
    def __init__(self, name, device, a, b):
        from torch.autograd import DeviceType
        self.name = name
        self.device_type = DeviceType.CUDA if device else DeviceType.CPU
        self.time_range = _Range(a, b)


def test_a_profile_is_read_by_markers_spans_and_gaps():
    """Device time between a span's markers, the busy union, the idle
    gaps named by the host span open as they began; the profiler's own
    device-side copies of the spans are not operations."""
    from portbench.harness import Profile
    ev = [_Event("pb.window", False, 0, 100),
          _Event("pb.stage1", False, 5, 40),
          _Event("pb.stage1", True, 10, 60),        # an annotation
          _Event("spin_kernel", True, 10, 11),
          _Event("node_bwd_x_kernel", True, 12, 30),
          _Event("Memcpy HtoD (Pinned -> Device)", True, 20, 25),
          _Event("spin_kernel", True, 31, 32),
          _Event("bn_fwd_kernel", True, 70, 80)]
    p = Profile(ev, [("stage1", "begin"), ("stage1", "end")], units=1)
    assert p.window_s == pytest.approx(100e-6) and p.kernels == 2
    assert p.segments("stage1") == [pytest.approx(18e-6)]
    assert p.busy_s == pytest.approx(28e-6)
    assert p.kernel_s("node_bwd") == pytest.approx(18e-6)
    gaps = {round(s * 1e6): n for n, s in p.idle_gaps()}
    assert gaps == {40: "pb.stage1", 20: "pb.loop", 12: "pb.loop"}
