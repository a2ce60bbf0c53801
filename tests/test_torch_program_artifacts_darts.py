"""The searched encoders' serving programs inside the artifact, on the
CPU: the PC-DARTS supernet (cut to two nodes a cell, its arch parameters
in the artifact) and a derived network with the kernel flags, written by
`export_state(platforms=("cpu",))` and read back in a process without
the model code, equal the eager `ServingModel` call bit for bit at
batches 1, 2 and 5. That process is given no genotype: the derived
network's is in its programs. The helpers and the other families are
tests/test_torch_program_artifacts.py's.
"""

import pytest

from test_torch_program_artifacts import (_Artifacts, check_round_trip,
                                          run_programs)
from test_torch_train import one_cpu_thread  # noqa: F401 (autouse)

ROUND_TRIP = ("darts", "derived")


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    return _Artifacts(tmp_path_factory.mktemp("darts_program_artifacts"))


@pytest.fixture(scope="module")
def program_run(artifacts, tmp_path_factory):
    return run_programs(artifacts, [(name,) for name in ROUND_TRIP],
                        tmp_path_factory.mktemp("darts_program_run"))


@pytest.mark.parametrize("name", ROUND_TRIP)
def test_programs_from_the_file_equal_the_eager_call(artifacts, program_run,
                                                     name):
    check_round_trip(artifacts, program_run, name)


def test_a_derived_artifact_serves_without_the_model_code(program_run):
    """The process that loaded and called the derived network's programs
    with no genotype (and the supernet's), with pickle's loaders and
    torch.load refused, imported neither the model code, the exporter,
    the data modules nor JAX."""
    assert program_run[1] == []
