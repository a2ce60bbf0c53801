"""Fixtures of the benchmark's CPU tests: each cell of BENCHMARK.json at a
size the CPU holds, with the model's own CPU routes (the kernels' plain
versions), in float32, and the limits of the cell as committed."""

from __future__ import annotations

import copy

import pytest
import torch

from portbench import run

# sizes a CPU run holds; every width of the cell's configuration is cut
TINY_MODEL = {"img_size": 32, "img_embed_size": 32, "word_embed_size": 16,
              "lstm_hidden_size": 32, "max_qst_len": 8, "qst_vocab_size": 64,
              "ans_vocab_size": 16, "vgg_width_mult": 0.125, "vgg_fc_dim": 64,
              "darts_init_ch": 4, "darts_layers": 3,
              "compute_dtype": "float32"}
TINY_MIX = {"train_questions": 64, "train_images": 16, "val_questions": 16,
            "val_images": 4, "batch": 16, "distinct_batches": 3,
            "rate": 50, "clients": 8, "trace_start": 10, "trace_units": 20,
            "words_pmf": {"3": 0.5, "4": 0.3, "5": 0.2}}
CELLS = ("lct_train_224", "vqa_answer_224", "vqa_serve_224",
         "ef_generate_224")
# the open-loop cell that the benchmark does not declare (its tail spread
# too widely for a bound): its files stay, and the tests drive them
SERVE = {"name": "vqa_serve_224", "config": "vqa_w_vgg19_224",
         "traffic": "serve_poisson", "chips": 1, "why": ""}
SERVE_E2E = {"name": "answer_p95_ms", "unit": "ms", "better": "lower",
             "bound": 0.25, "source": "host_clock",
             "workloads": ["vqa_serve_224"]}


def bench() -> dict:
    b = run.load_json(run.ROOT / "BENCHMARK.json")
    if SERVE["name"] not in {w["name"] for w in b["workloads"]}:
        b["workloads"].append(SERVE)
        b["end_to_end"].append(SERVE_E2E)
    return b


def tiny_spec(cell: str) -> dict:
    """The cell as `run.lookup` finds it, cut to the tiny sizes."""
    spec = copy.deepcopy(run.lookup(bench(), cell))
    m = spec["config"]["model"]
    m.update({k: v for k, v in TINY_MODEL.items()
              if k in m or not k.startswith("darts")})
    if "train" in spec["config"]:
        spec["config"]["train"]["batch_size"] = 16
    mix = spec["mix"]
    mix.update({k: v for k, v in TINY_MIX.items() if k in mix})
    return spec


@pytest.fixture(autouse=True)
def few_threads():
    was = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(was)


@pytest.fixture
def cpu():
    return torch.device("cpu")
