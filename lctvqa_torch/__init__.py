"""lctvqa_torch: the PyTorch and CUDA port of lctvqa for NVIDIA Hopper.

The JAX package `lctvqa` stays the reference; modules here mirror its
names. This package imports `torch`, never `jax`, and nothing of
`lctvqa`: it keeps its own copy of what it needs from there (config,
text, genotypes, the artifact reader and writer).

Ported so far: serving an exported artifact (W model, EF model with the
fixed VGG19 encoder, the PC-DARTS supernet or a derived network, the
unified QA-stream model), the LCT search (`main.py`, stages 3, 1 and 2,
on the h5 files or the npy records), the 2-stage DARTS loop and its
unified variant (`train/experiment_darts.py`), the genotype decode, the
derived retrain and the checkpoint eval with BLEU4 (`genotype.py`,
`eval.py`), int8 serving (`quant.py`) and the export CLI (`export.py`),
the LCT loop's statistics files (`train/stats.py`), data parallelism over
torch.distributed and tensor-parallel eval (`parallel/`), the offline
data builders and download list (`data/build.py`, `data/preprocess.py`,
`data/download.py`), the C++ gather core that assembles batches
(`native/`), and eight kernels in CUDA (`csrc/`): the four LSTM-family
kernels, the node-batched mixed op and the batch-stat BatchNorm, forward
and backward, the last also in a two-launch mode for the global
statistics of several ranks.
"""

__version__ = "0.1.0"
