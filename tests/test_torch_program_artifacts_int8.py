"""The int8 serving programs inside the artifact, on the CPU: the int8 W
and int8 derived-EF artifacts' programs, written by
`export_state(int8=True, platforms=("cpu",))` and read back in a process
without the model code, equal the eager `ServingModel` call bit for bit
at batches 1, 2 and 5 (the CPU's int8 products are the plain version,
traced as they are), and the files hold JSON and listed raw constants
only. The helpers and the other families are
tests/test_torch_program_artifacts.py's.
"""

import pytest

from test_torch_program_artifacts import (_Artifacts, check_members,
                                          check_round_trip, run_programs)
from test_torch_train import one_cpu_thread  # noqa: F401 (autouse)

ROUND_TRIP = ("w_int8", "derived_int8")


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    return _Artifacts(tmp_path_factory.mktemp("int8_program_artifacts"))


@pytest.fixture(scope="module")
def program_run(artifacts, tmp_path_factory):
    return run_programs(artifacts, [(name,) for name in ROUND_TRIP],
                        tmp_path_factory.mktemp("int8_program_run"))


@pytest.mark.parametrize("name", ROUND_TRIP)
def test_programs_from_the_file_equal_the_eager_call(artifacts, program_run,
                                                     name):
    check_round_trip(artifacts, program_run, name)


def test_programs_run_without_the_model_code(program_run):
    assert program_run[1] == []


def test_program_members_are_json_or_listed_raw_constants(artifacts):
    check_members(artifacts["w_int8"], "w")
