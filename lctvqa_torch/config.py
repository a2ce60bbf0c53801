"""Immutable configuration (the port's own copy of lctvqa/config.py).

One frozen dataclass tree, built once and passed explicitly. Field names
and defaults are the JAX package's, so that a config of either package
describes the same model; `MeshConfig` is left out until a ported module
reads it. The kernel flags keep their JAX names (`use_pallas_lstm`,
`pallas_seq_lstm`, `pallas_generate`, `pallas_mixed_op`): here each one
routes CUDA tensors through the CUDA kernel that replaces that Pallas
kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Shapes shared by the W and EF models."""

    img_embed_size: int = 512
    word_embed_size: int = 300
    lstm_hidden_size: int = 512
    lstm_num_layers: int = 1
    max_qst_len: int = 30
    qst_vocab_size: int = 8192
    ans_vocab_size: int = 1000
    img_size: int = 64
    dropout_rate: float = 0.5
    # 'fixed' -> VGG19 image encoder; 'darts' -> PC-DARTS search network;
    # 'derived' -> fixed network built from `genotype` (not ported yet).
    arch_type: str = "darts"
    genotype: object = None
    pretrained_enc: bool = True
    # test-only shrink knobs for the VGG19 trunk (production: 1.0 / 4096)
    vgg_width_mult: float = 1.0
    vgg_fc_dim: int = 4096
    # PC-DARTS search-space shape
    darts_init_ch: int = 16
    darts_layers: int = 4
    darts_steps: int = 4
    darts_multiplier: int = 4
    darts_stem_multiplier: int = 3
    darts_partial_k: int = 4       # channel proportion 1/k
    # params are always fp32; compute_dtype is the matmul operand dtype
    compute_dtype: str = "bfloat16"
    # the fused LSTM cell kernel
    use_pallas_lstm: bool = True
    # the whole-sequence LSTM kernels
    pallas_seq_lstm: bool = False
    # the whole-loop greedy decode kernel
    pallas_generate: bool = False
    # JAX-only ways of running the supernet; the port raises when set
    fuse_mixed_ops: bool = False
    pack_conv_branches: bool = False
    remat_cells: bool = False
    # running BatchNorm statistics at eval; forces the unfolded mixture
    bn_eval_stats: bool = False
    # fold each primitive's final affine-free BN into the alpha mixture
    # (models/search.py::_mixed_fold): same math, the normalized
    # intermediates are never written
    fold_bn_mixture: bool = True
    # run each cell node's stride-1 edges as one call of the mixed-op node
    # kernel (ops/cuda_mixedop.py); needs fold_bn_mixture
    pallas_mixed_op: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization hyperparameters."""

    learning_rate: float = 1e-3
    step_size: int = 10
    lr_decay: float = 0.1
    arch_learning_rate: float = 6e-4
    arch_weight_decay: float = 1e-3
    arch_adam_b1: float = 0.5
    arch_adam_b2: float = 0.999
    grad_clip: float = 5.0
    temperature: float = 0.1
    batch_size: int = 64
    num_epochs: int = 30
    train_portion: float = 1.0
    seed: int = 10
    arch_update_freq: int = 2000
    arch_update_freq_min: int = 100
    arch_freq_decay: float = 0.5
    skip_stage2: bool = False
    skip_stage3: bool = True
    w_lambda: float = 1.0
    report_freq: int = 10
    # 'exact' | 'exact-indirect' | 'fd' (see lctvqa/config.py)
    architect_mode: str = "exact-indirect"
    stage3_remat: bool = True
    packed_dispatch: bool = True


@dataclasses.dataclass(frozen=True)
class DataConfig:
    input_dir: str = "data/vqa/hdf5_64"
    num_workers: int = 8
    use_old_dataloader: bool = False
    max_num_ans: int = 10
    prefetch: int = 2
    preload_images: str = "auto"
    # ImageNet normalization
    mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: Tuple[float, float, float] = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    exp_name: str = "default_exp"
    resume: bool = False
    root_stats_dir: str = "./experiment_data"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def small_test_config() -> Config:
    """A tiny config used by tests."""
    return Config(
        model=ModelConfig(
            img_embed_size=32,
            word_embed_size=16,
            lstm_hidden_size=32,
            max_qst_len=8,
            qst_vocab_size=64,
            ans_vocab_size=16,
            img_size=16,
            darts_init_ch=4,
            darts_layers=2,
            compute_dtype="float32",
            vgg_width_mult=0.125,
            vgg_fc_dim=64,
        ),
        train=TrainConfig(batch_size=8, num_epochs=1, arch_update_freq=1,
                          skip_stage3=False),
    )
