"""The cell `derived_train_224` on the CPU at a tiny size (`conftest.py`'s
`tiny_spec`: C 4, 3 cells, 32 px, batch 16, fp32): a sound run comes out
correct under the cell's limits; each planted fault and the float8
control (the driver's `control()`) come out not correct; the program's
span and counter reach the readers through the window's result; and
`flops_derived.py` counts the products that the reference network
runs."""

from __future__ import annotations

import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import tiny_spec
from portbench import flops_derived, run
from portbench.harness import Tracer
from portbench.reference import derived as D
from portbench.reference import model as R
from portbench.reference import params as P

CELL = "derived_train_224"
SEED = 2 ** 31 + 977   # more than 32 signed bits hold


def test_a_sound_run_is_correct(cpu):
    r = run.execute(tiny_spec(CELL), SEED, 1.0, False, cpu)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"train_pairs_s", "setup_s"}


@pytest.mark.parametrize("fault", ["frozen", "half_batch", "token"])
def test_a_broken_timed_path_is_not_correct(fault, cpu):
    r = run.execute(tiny_spec(CELL), SEED, 0.5, False, cpu, fault=fault)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", [
    lambda y: torch.roll(y, 1, 1),     # the pooled map one pixel off
    lambda y: y * 1.1])                # a tenth too large
def test_a_fault_in_the_reduction_cells_alone_is_not_correct(fault, cpu,
                                                             monkeypatch):
    """The pools without BatchNorm live only in the reduction cells (1
    and 2 here, 4 and 9 at the published size): a fault there reads in
    `cell_gap`, each cell checked on the program's own inputs to it."""
    from lctvqa_torch.models import derived
    pool = derived._pool
    monkeypatch.setattr(derived, "_pool", lambda *a: fault(pool(*a)))
    r = run.execute(tiny_spec(CELL), SEED, 0.5, False, cpu)
    assert not r["correct"]
    c = r["checks"]["cell_gap"]
    assert c["value"] > c["limit"], r["checks"]


def test_the_float8_control_is_not_correct(cpu):
    """The driver's `control()`: the reference with fp8 operands in the
    program's place, on the same steps."""
    spec = tiny_spec(CELL)
    drv = run.driver_class(spec["mix"])(run.Context(spec, SEED, cpu))
    drv.setup()
    drv.release()
    assert run.judge(drv.check(), spec["limits"]["numbers"])
    assert not run.judge(drv.control(), spec["limits"]["numbers"])


def test_the_program_table_reaches_the_readers(cpu):
    """The window's span and count table: two `ef.trunk` a step, and 2 x 44
    plain affine BatchNorms a step (3 in the stems, 13 in the normal cell,
    14 in each of the two reduction cells)."""
    spec = tiny_spec(CELL)
    drv = run.driver_class(spec["mix"])(run.Context(spec, SEED, cpu))
    drv.setup()
    window = drv.window(0.3, Tracer(False))
    drv.release()
    counts = window["program"]["counts"]
    assert counts["ef.trunk"] == 2 * window["units"]
    assert "bn.kernel" not in counts and "bn.plain" not in counts
    r = types.SimpleNamespace(window=window, profile=None)
    assert run.reader("plain_affine_bn_per_step.dtrain")(r) == 88
    assert run.reader("trunk_host_ms.dtrain")(r) > 0
    assert run.reader("trunk_fwd_device_ms.dtrain")(r) is None


@pytest.mark.parametrize("sizes", [dict(darts_init_ch=4, darts_layers=3,
                                        img_size=32),
                                   dict(darts_init_ch=8, darts_layers=5,
                                        img_size=64)])
def test_the_flops_are_the_reference_networks_products(sizes):
    """The trunk's count against torch's count of every convolution the
    reference runs, and the EF's forward against the whole reference
    forward's products."""
    m = dict(tiny_spec(CELL)["config"]["model"], **sizes)
    tree = P.make(D.ef_shapes(m), 1, "cpu")
    n = 2
    x = torch.randn(n, 3, m["img_size"], m["img_size"])
    qst = torch.randint(0, m["qst_vocab_size"], (n, m["max_qst_len"]))
    with torch.no_grad():
        with FlopCounterMode(display=False) as trunk:
            D.network(R.EXACT, tree["derived"], m, x)
        with FlopCounterMode(display=False) as ef:
            D.ef_forward(R.EXACT, tree, m, x, qst, None)
    assert flops_derived.trunk_fwd_flops(m, n) == trunk.get_total_flops()
    assert flops_derived.ef_fwd_flops(m, n) == ef.get_total_flops()
