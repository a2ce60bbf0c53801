"""The port's spans (lctvqa_torch/trace.py) and the benchmark's reading
of them (portbench/idle.py), on the CPU at `small_test_config` sizes.

Contract: with no profiler recording a span opens no record function
and adds its host time to the process-wide table; while one records,
each span is a host operator named `lctvqa.<name>` on the calling thread
and not a user annotation (which the profiler would copy onto the
device's timeline); a training step emits the stage spans nested in
the step's, a serving call its own around its inputs' conversion, and a
program exported while a profiler records holds no profiler operator.
The harness's reading of a profiled stretch is the same with and
without the program's spans in it, and `portbench/idle.py` puts each
idle instant inside the spans open on the driver's thread or outside
them all.
"""

import dataclasses
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from lctvqa_torch import export, trace
from lctvqa_torch.config import small_test_config
from lctvqa_torch.data import pipeline, synthetic
from lctvqa_torch.models import genotypes, vqa_w
from lctvqa_torch.train.experiment import Experiment

REPO = Path(__file__).resolve().parents[1]
STAGES = {
    "lctvqa.train.stage1": ["lctvqa.stage1.forward", "lctvqa.stage1.backward",
                            "lctvqa.stage1.optimizer"],
    "lctvqa.train.stage2": ["lctvqa.stage2.generate", "lctvqa.stage2.forward",
                            "lctvqa.stage2.backward",
                            "lctvqa.stage2.optimizer"],
}


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One PyTorch intra-op thread, as tests/test_torch_train.py's fixture
    of that name (not imported: that file imports JAX)."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _program(events):
    """The program's spans -> {name: [(start, end, thread, event)]}."""
    out = {}
    for e in events:
        if e.name.startswith(trace.PREFIX):
            out.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end, e.thread, e))
    return out


def _caller_thread(events):
    return next(e.thread for e in events if e.name == "test.caller")


def test_a_span_without_a_profiler_opens_no_record_function(monkeypatch):
    opened = []
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        lambda name: opened.append(name))
    trace.TABLE.reset()
    for _ in range(2):
        with trace.span("unit.test"):
            time.sleep(0.005)
    assert opened == []
    assert trace.TABLE.counts["unit.test"] == 2
    assert trace.TABLE.totals["unit.test"] >= 0.01
    line = trace.TABLE.summary()
    assert line.startswith("host enqueue times: ")
    assert "unit.test: " in line and "/2 (" in line and "| wall: " in line
    trace.TABLE.reset()
    assert "unit.test" not in trace.TABLE.summary()


def test_a_span_under_a_profiler_is_a_host_operator_on_the_caller():
    trace.TABLE.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.caller"):
            with trace.span("outer"):
                with trace.span("inner"):
                    torch.ones(4).add_(1)
    events = prof.events()
    spans = _program(events)
    assert set(spans) == {"lctvqa.outer", "lctvqa.inner"}
    (oa, ob, othread, outer), = spans["lctvqa.outer"]
    (ia, ib, ithread, inner), = spans["lctvqa.inner"]
    assert oa <= ia < ib <= ob
    assert othread == ithread == _caller_thread(events)
    # an operator's record function: the profiler copies only user
    # annotations onto the device's timeline
    assert not outer.is_user_annotation and not inner.is_user_annotation
    assert trace.TABLE.counts["outer"] == trace.TABLE.counts["inner"] == 1


def _experiment(tmp_path):
    cfg = small_test_config()
    model = dataclasses.replace(
        cfg.model, img_embed_size=16, word_embed_size=8, lstm_hidden_size=16,
        max_qst_len=8, img_size=32, darts_layers=1, darts_steps=2,
        darts_multiplier=2, vgg_width_mult=1 / 16, vgg_fc_dim=32,
        qst_vocab_size=24, ans_vocab_size=16)
    cfg = cfg.replace(
        model=model, root_stats_dir=str(tmp_path), exp_name="exp",
        train=dataclasses.replace(cfg.train, skip_stage3=True, batch_size=8))
    arrays = synthetic.make_arrays(num_images=8, num_questions=16,
                                   img_size=32, n_answers=16)
    return Experiment(cfg, device="cpu",
                      data=pipeline.loader_from_arrays(arrays))


def test_a_training_step_emits_its_spans_nested_on_the_calling_thread(
        tmp_path):
    exp = _experiment(tmp_path)
    feed = exp._batches("train")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.caller"):
            batch = next(feed)
            exp.train_step(batch)
    events = prof.events()
    spans = _program(events)
    names = {"lctvqa.feed.wait", *STAGES, *(c for cs in STAGES.values()
                                             for c in cs)}
    assert set(spans) == names
    assert all(len(v) == 1 for v in spans.values())
    assert {s[0][2] for s in spans.values()} == {_caller_thread(events)}
    # the feed's wait, then stage 1, then stage 2; each stage's phases in
    # order inside it
    order = [spans[n][0][:2] for n in ("lctvqa.feed.wait", *STAGES)]
    assert all(a[1] <= b[0] for a, b in zip(order, order[1:]))
    for stage, phases in STAGES.items():
        sa, sb = spans[stage][0][:2]
        inner = [spans[n][0][:2] for n in phases]
        assert sa <= inner[0][0] and inner[-1][1] <= sb
        assert all(a[1] <= b[0] for a, b in zip(inner, inner[1:]))
    # the TIMING line's table holds the same spans, with host times
    line = trace.TABLE.summary()
    for name in names:
        assert name[len(trace.PREFIX):] + ": " in line


def _w_model():
    mcfg = dataclasses.replace(small_test_config().model,
                               compute_dtype="float32", arch_type="fixed",
                               img_size=32)
    params = vqa_w.init_w_model(torch.Generator().manual_seed(3), mcfg)
    artifact = export.export_state({"w_params": params}, mcfg)
    return export.ServingModel(artifact, "cpu", compute_dtype="float32")


@pytest.fixture(scope="module")
def w_model():
    return _w_model()


def test_answer_logits_emits_its_span_around_the_inputs(w_model):
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    qst = rng.integers(0, 64, (2, 8), dtype=np.int32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.caller"):
            w_model.answer_logits(u8, qst)
    events = prof.events()
    spans = _program(events)
    assert set(spans) == {"lctvqa.serve.answer_logits", "lctvqa.serve.input"}
    (ca, cb, thread, _), = spans["lctvqa.serve.answer_logits"]
    assert len(spans["lctvqa.serve.input"]) == 2
    assert all(ca <= a < b <= cb and t == thread
               for a, b, t, _ in spans["lctvqa.serve.input"])
    assert thread == _caller_thread(events)


def _targets(program):
    return [str(node.target) for node in program.graph.nodes
            if node.op == "call_function"]


def test_a_program_exported_under_a_profiler_holds_no_profiler_op(w_model):
    """The same graph as an export with no profiler, and no profiler
    operator in it."""
    with profile(activities=[ProfilerActivity.CPU]):
        recorded = export.export_programs(w_model, max_batch=4)
    plain = export.export_programs(w_model, max_batch=4)
    targets = _targets(recorded["answer_logits"])
    assert targets == _targets(plain["answer_logits"])
    assert targets and not [t for t in targets if "profiler" in t]


# ---------------------------------------------------------------------------
# the derived EF's trunk span and the BatchNorm routes' counts
# ---------------------------------------------------------------------------

def _derived_experiment(tmp_path, skeleton="imagenet", name="PC_DARTS_image"):
    """A derived EF of `name` on `skeleton`, two cells (the second a
    reduction), 32 px."""
    exp = _experiment(tmp_path)
    g = getattr(genotypes, name)
    cfg = exp.cfg.replace(model=dataclasses.replace(
        exp.cfg.model, arch_type="derived", genotype=g,
        derived_skeleton=skeleton, darts_init_ch=4, darts_layers=2,
        darts_steps=len(g.normal) // 2,
        darts_multiplier=len(g.normal_concat), compute_dtype="float32"),
        exp_name=f"derived_{skeleton}")
    arrays = synthetic.make_arrays(num_images=8, num_questions=16,
                                   img_size=32, n_answers=16)
    return Experiment(cfg, device="cpu",
                      data=pipeline.loader_from_arrays(arrays))


def test_ef_trunk_opens_once_a_trunk_forward(tmp_path, monkeypatch):
    """Stage 1's forward and stage 2's generation: one `ef.trunk` each,
    and one trunk forward inside each."""
    from lctvqa_torch.models import derived
    exp = _derived_experiment(tmp_path)
    plain, calls = derived.derived_network_apply, []

    def counted(*a, **k):
        calls.append(trace.TABLE.counts["ef.trunk"])
        return plain(*a, **k)

    monkeypatch.setattr(derived, "derived_network_apply", counted)
    batch = next(exp._batches("train"))
    trace.TABLE.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        exp.train_step(batch)
    assert trace.TABLE.counts["ef.trunk"] == len(calls) == 2
    # each forward ran inside its span: the count rises as the span ends
    assert calls == [0, 1]
    spans = _program(prof.events())
    (s1a, s1b, _, _), = spans["lctvqa.stage1.forward"]
    (s2a, s2b, _, _), = spans["lctvqa.stage2.generate"]
    first, second = sorted(spans["lctvqa.ef.trunk"])
    assert s1a <= first[0] < first[1] <= s1b
    assert s2a <= second[0] < second[1] <= s2b


def test_no_span_or_count_lands_while_a_program_is_exported(tmp_path):
    exp = _derived_experiment(tmp_path)
    artifact = export.export_state({"ef_params": exp.ef_params},
                                   exp.cfg.model)
    model = export.ServingModel(artifact, "cpu", genotypes.PC_DARTS_image,
                                compute_dtype="float32")
    trace.TABLE.reset()
    export.export_programs(model, max_batch=2)
    assert dict(trace.TABLE.counts) == {}
    assert dict(trace.TABLE.totals) == {}


def test_the_bn_routes_add_up_to_the_batchnorm_calls_of_a_step(
        tmp_path, monkeypatch):
    """A derived EF on the search skeleton, whose pools' BatchNorms are
    affine-free, with the BatchNorm kernel's switch on: stage 1's take
    the plain route (a gradient on the CPU), stage 2's generation the
    operator (`bn.kernel`), every affine one `bn.plain_affine`."""
    from lctvqa_torch.ops import conv
    exp = _derived_experiment(tmp_path, "search", "PC_DARTS_cifar")
    monkeypatch.setattr(conv, "USE_PALLAS_BN", True)
    plain, calls = conv.batchnorm, []

    def counted(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(conv, "batchnorm", counted)
    batch = next(exp._batches("train"))
    trace.TABLE.reset()
    exp.train_step(batch)
    routes = {r: trace.TABLE.counts[r]
              for r in ("bn.kernel", "bn.plain", "bn.plain_affine")}
    assert all(routes.values()), routes
    assert sum(routes.values()) == len(calls)
    assert "bn.plain_affine: " in trace.TABLE.summary()


def test_a_span_and_a_count_leave_the_operators_as_they_were(
        tmp_path, monkeypatch):
    """The same step's operators on the calling thread, and the harness's
    kernel count, with the program's spans and counts and with both made
    no-ops: nothing but the `lctvqa.` host operators differs."""
    import collections
    import contextlib

    from portbench.harness import Profile
    from lctvqa_torch.train import steps

    def operators(exp):
        batch = next(exp._batches("train"))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("test.caller"):
                exp.train_step(batch)
        events = prof.events()
        thread = _caller_thread(events)
        names = collections.Counter(
            e.name for e in events if e.thread == thread
            and not e.name.startswith(trace.PREFIX))
        return names, Profile(events, [], units=1).kernels

    with_spans = operators(_derived_experiment(tmp_path / "a"))
    monkeypatch.setattr(steps, "span", lambda name: contextlib.nullcontext())
    monkeypatch.setattr(trace, "count", lambda name: None)
    without = operators(_derived_experiment(tmp_path / "b"))
    assert with_spans == without


# ---------------------------------------------------------------------------
# the benchmark's reading of a profiled stretch
# ---------------------------------------------------------------------------

class _Range:
    def __init__(self, a, b):
        self.start, self.end = a, b


class _Event:
    def __init__(self, name, device, a, b, thread=1):
        from torch.autograd import DeviceType
        self.name = name
        self.device_type = DeviceType.CUDA if device else DeviceType.CPU
        self.time_range = _Range(a, b)
        self.thread = thread


# a stretch of 100 us: the harness's window and stage-1 span with its
# markers, two kernels, a copy; device busy 12-30 and 70-80
HARNESS = [_Event("pb.window", False, 0, 100),
           _Event("pb.stage1", False, 5, 60),
           _Event("pb.stage1", True, 10, 60),          # its annotation
           _Event("spin_kernel", True, 10, 11),
           _Event("node_bwd_x_kernel", True, 12, 30),
           _Event("Memcpy HtoD (Pinned -> Device)", True, 20, 25),
           _Event("spin_kernel", True, 59, 60),
           _Event("bn_fwd_kernel", True, 70, 80)]
# the program's spans on the driver's thread, and one on another thread
PROGRAM = [_Event("lctvqa.train.stage1", False, 2, 65),
           _Event("lctvqa.stage1.forward", False, 3, 20),
           _Event("lctvqa.stage1.backward", False, 20, 50),
           _Event("lctvqa.stage1.optimizer", False, 50, 64),
           _Event("lctvqa.feed.wait", False, 85, 95),
           _Event("lctvqa.feed.wait", False, 0, 100, thread=2)]
LOG = [("stage1", "begin"), ("stage1", "end")]


def _readers():
    import importlib.util
    out = {}
    for path in sorted((REPO / "portbench" / "metrics").glob("*.py")):
        spec = importlib.util.spec_from_file_location(
            "trace_test_" + path.stem.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[path.stem] = mod.read
    return out


def _readings(events):
    from portbench.harness import Profile
    p = Profile(events, LOG, units=1)
    run = types.SimpleNamespace(
        profile=p, window={"seconds": 1.0, "flops": 1e9, "units": 1},
        tracer=types.SimpleNamespace(host={"prefetch_next": [1e-3]},
                                     profile=p),
        shapes=types.SimpleNamespace(node=[], bn=[], decode=[]),
        model=small_test_config().model.__dict__)
    got = {"kernels": p.kernels, "busy_s": p.busy_s, "window_s": p.window_s,
           "segments": p.segments("stage1"), "top_ops": p.top_ops(),
           "idle_gaps": p.idle_gaps(), "h2d_s": p.h2d_s()}
    for name, read in _readers().items():
        try:
            got[name] = read(run)
        except (AttributeError, KeyError, TypeError) as exc:
            got[name] = repr(exc)
    return got


def test_the_harness_reads_a_stretch_alike_with_and_without_spans():
    plain, spanned = _readings(HARNESS), _readings(HARNESS + PROGRAM)
    assert spanned == plain
    assert plain["kernels"] == 2 and plain["busy_s"] == pytest.approx(28e-6)


def test_idle_is_put_down_to_the_spans_open_on_the_driver_thread():
    from portbench.harness import Profile
    from portbench.idle import Spans
    events = HARNESS + PROGRAM
    p = Profile(events, LOG, units=2)
    s = Spans(events, p)
    assert s.thread == 1 and len(s.program) == 5  # thread 2's left out
    assert s.idle() == [(0, 12), (30, 70), (80, 100)]
    us = 1e-6
    by_hand = {"lctvqa.train.stage1": 10 + 35,
               "lctvqa.stage1.forward": 9,
               "lctvqa.stage1.backward": 20,
               "lctvqa.stage1.optimizer": 14,
               "lctvqa.feed.wait": 10}
    for name, idle in by_hand.items():
        assert s.idle_inside(name) == pytest.approx(idle * us), name
    # every idle instant lies inside some span or outside all of them
    inside = s.idle_inside()
    assert inside == pytest.approx((10 + 35 + 10) * us)
    total = p.window_s - p.busy_s
    assert sum(b - a for a, b in s.idle()) * us == pytest.approx(total)
    r = s.reading()
    assert r["idle_ms"] == pytest.approx(1e3 * total / 2)
    assert r["idle_outside_ms"] + 1e3 * inside / 2 == pytest.approx(
        r["idle_ms"])
    assert r["idle_outside_share"] == pytest.approx(17 / 72)
    assert r["spans"]["lctvqa.feed.wait"] == pytest.approx(
        {"count": 0.5, "host_ms": 5e-3, "idle_ms": 5e-3})
    assert r["device_events_named_by_spans"] == []
    # each gap named by the innermost span open as it began: the harness's
    # where no program span is open, the program's inside it
    gaps = {round(sec / us): name for name, sec in s.idle_gaps()}
    assert gaps == {40: "lctvqa.stage1.backward", 20: "pb.loop",
                    12: "pb.loop"}
    assert {round(sec / us): name for name, sec in p.idle_gaps()} == {
        40: "pb.stage1", 20: "pb.loop", 12: "pb.loop"}
