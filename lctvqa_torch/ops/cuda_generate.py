"""Whole-loop greedy decode as one kernel.

Counterpart of `lctvqa/ops/pallas_generate.py`; the kernel is in
`lctvqa_torch/csrc/generate.cu`. It mirrors the model's greedy decode
(`models/qst_encoder.ef_qst_generate`): h0 = c0 = the image embedding,
x0 = tanh(table[<start>]); per step the LSTM cell, logits =
fc2(tanh h), the first maximum, and the next x = table[token] with no
tanh. Matmul operands are rounded to the compute dtype, sums are fp32,
the embedding rows stay fp32. Tokens are integers: no gradient.

The kernel is one persistent grid, launched cooperatively: gate blocks
keep their slice of the LSTM weights in shared memory and head blocks
their column slice of the vocabulary head (bf16; in fp32 the head is read
from L2 each step), with two hand-overs a step (`generate_plan` mirrors
the launch shape the C side takes; `generate_scratch_bytes` the zeroed
scratch a call needs). All its blocks must be resident at once: a card
too small for the grid makes the wrapper raise.

On CPU tensors the plain version runs, which is the model's own decode
loop with the plain LSTM cell; on CUDA tensors the kernel launches or the
call raises. A call is the operator `lctvqa_torch::greedy_generate`
(`_build.define_op`), on either device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from lctvqa_torch.ops import _build as K
from lctvqa_torch.ops.cuda_lstm import (SMEM_PER_BLOCK, CellWeights,
                                        cell_weights)

f32 = torch.float32

GENERATE = K.register(K.Kernel("greedy_generate", "lctvqa_greedy_generate",
                               [K.PTR] * 10 + [K.INT] * 6))

# the launch shape (csrc/generate.cu, namespace gen)
GEN_THREADS = 512
GEN_UNITS = 8        # hidden units of a gate block
GEN_SYNC_BYTES = 256  # the two hand-over counters, padded


def greedy_generate_plain(qst_params, image_embedding: torch.Tensor,
                          max_length: int,
                          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The decode loop in plain PyTorch. Returns int32 [B, max_length]."""
    from lctvqa_torch.models.qst_encoder import ef_qst_generate

    return ef_qst_generate(qst_params, image_embedding, max_length,
                           dtype=dtype, use_kernel=False,
                           use_generate_kernel=False)


class DecodeWeights(NamedTuple):
    """The decode's weights as the kernel takes them."""

    cell: CellWeights
    table: torch.Tensor  # [V, E] fp32 embedding table
    x0: torch.Tensor     # [E] fp32, tanh(table[<start>])
    fc2_w: torch.Tensor  # [H, V8] compute dtype, V padded to V8 = 8k
    fc2_b: torch.Tensor  # [V8] fp32, -inf in the padding


def decode_weights(qst_params,
                   dtype: Optional[torch.dtype] = None) -> DecodeWeights:
    """Cast and pad the decode's weights once. The kernel reads the head in
    8-column, 16-byte pieces, so V is padded to a multiple of 8 with
    columns that never win (weight 0, bias -inf). Question-encoder params
    that hold them under "decode" (a served model's) return them."""
    from lctvqa_torch.models.qst_encoder import START_TOKEN

    if "decode" in qst_params:
        d = qst_params["decode"]
        if d.cell.w_ih.dtype != (dtype or f32):
            raise ValueError(f"decode weights cast to {d.cell.w_ih.dtype}, "
                             f"called with {dtype}")
        return d
    layers = qst_params["lstm"]["layers"]
    K.check(len(layers) == 1, GENERATE.name, "needs num_layers=1")
    cell = cell_weights(layers[0], dtype)
    table = qst_params["word2vec"]["table"].to(f32).contiguous()
    fc2_w = qst_params["fc2"]["w"].to(cell.w_ih.dtype)
    fc2_b = qst_params["fc2"]["b"].to(f32)
    pad = -fc2_w.shape[1] % 8
    fc2_w = torch.nn.functional.pad(fc2_w, (0, pad)).contiguous()
    fc2_b = torch.cat([fc2_b, fc2_b.new_full((pad,), float("-inf"))])
    return DecodeWeights(cell, table,
                         torch.tanh(table[START_TOKEN]).contiguous(),
                         fc2_w, fc2_b)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


@functools.lru_cache(maxsize=64)
def generate_plan(emb: int, hid: int, vpad: int, dtype: torch.dtype,
                  sm_count: int, smem_max: int = SMEM_PER_BLOCK) -> dict:
    """The decode kernel's launch shape on a card of `sm_count` SMs, as the
    C entry point chooses it. One block of 512 threads per SM at most:
    ceil(H / 8) gate blocks, each owning 8 hidden units (all four gates)
    with its [E + H, 32] slice of [W_ih; W_hh] resident; the other SMs take
    the vocabulary head, `head_cols` columns a block (the padded vocabulary
    over the SMs left, rounded up to 8). Batch tiles: the gates in bf16 the
    largest of 64, 32, 16 rows whose role fits in shared memory, in fp32
    16; the head in bf16 likewise (its slice resident), in fp32 64 (its
    slice read from L2). Raises ValueError where no shape fits."""
    mma = dtype == torch.bfloat16
    if dtype not in (torch.bfloat16, f32):
        raise ValueError(f"greedy_generate: compute dtype {dtype} is not "
                         "supported by the kernel (float32 or bfloat16)")
    size = 2 if mma else 4
    gates = -(-hid // GEN_UNITS)
    if sm_count - gates < 1:
        raise ValueError(f"greedy_generate: H={hid} needs {gates} gate blocks "
                         f"and at least one head block, more than {sm_count} "
                         "resident blocks")
    cols = _round_up(-(-vpad // (sm_count - gates)), 8)
    ep = _round_up(emb, 16)
    kp = _round_up(ep + hid, 128 if mma else 64)
    stride = kp + 16 // size
    partial = 32768  # lstm_seq.cuh's partial sums at 8 units
    weights = 4 * GEN_UNITS * stride * 2 if mma else kp * 4 * GEN_UNITS * 4

    def gate_smem(tile):
        return partial + weights + tile * stride * size

    def head_smem(tile):
        if not mma:
            return tile * _round_up(hid, 8) * 4
        sh, vca = _round_up(hid, 16) + 8, _round_up(cols, 32)
        return (vca + tile) * sh * 2 + vca * 4 + 4 * tile * 8

    tiles = (64, 32, 16) if mma else (16,)
    gate_tile = next((t for t in tiles if gate_smem(t) <= smem_max), None)
    tiles = (64, 32, 16) if mma else (64,)
    head_tile = next((t for t in tiles if head_smem(t) <= smem_max), None)
    if gate_tile is None or head_tile is None:
        raise ValueError(f"greedy_generate: E={emb}, H={hid}, V={vpad} too "
                         f"large: a gate or head block needs more than "
                         f"{smem_max} bytes of shared memory in {dtype} on "
                         f"{sm_count} SMs")
    heads = -(-vpad // cols)
    return {"blocks": gates + heads, "threads": GEN_THREADS,
            "gate_blocks": gates, "units": GEN_UNITS, "gate_tile": gate_tile,
            "head_blocks": heads, "head_cols": cols, "head_tile": head_tile,
            "smem_bytes": max(gate_smem(gate_tile), head_smem(head_tile))}


def generate_scratch_bytes(bsz: int, steps: int, hid: int,
                           dtype: torch.dtype) -> int:
    """Bytes of zeroed scratch one decode call needs: the two hand-over
    counters, the keys of every step [steps, B] (64-bit), the h exchange
    [2, B, HX] and the head's input [B, HX] of the compute dtype (HX = H
    rounded up to 8: rows start on 16 bytes), c [B, H] fp32."""
    size = 2 if dtype == torch.bfloat16 else 4
    hx = _round_up(hid, 8)
    return (GEN_SYNC_BYTES + _round_up(8 * bsz * steps, 16)
            + 3 * bsz * hx * size + _round_up(4 * bsz * hid, 16))


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def generate_plan_on_device(emb: int, hid: int, vpad: int,
                            dtype: torch.dtype,
                            device: torch.device) -> dict:
    """The launch shape the C entry point takes on `device` (it asks the
    card for its SMs and shared memory): `generate_plan`'s keys."""
    import ctypes

    fn = K.library().lctvqa_greedy_generate_plan
    fn.argtypes = [K.INT] * 4 + [ctypes.POINTER(K.INT * 6)]
    fn.restype = K.INT
    plan = (K.INT * 6)()
    with torch.cuda.device(device):
        rc = fn(emb, hid, vpad, K.dtype_code(GENERATE.name, dtype),
                ctypes.byref(plan))
    if rc != 0:
        msg = K.library().lctvqa_cuda_error_string(rc).decode()
        raise RuntimeError(f"greedy_generate: no launch shape for E={emb}, "
                           f"H={hid}, V={vpad} in {dtype} on {device}: {msg} "
                           f"(cudaError {rc})")
    gates, gate_tile, heads, cols, head_tile, smem = plan
    return {"blocks": gates + heads, "threads": GEN_THREADS,
            "gate_blocks": gates, "units": GEN_UNITS, "gate_tile": gate_tile,
            "head_blocks": heads, "head_cols": cols, "head_tile": head_tile,
            "smem_bytes": smem}


def _generate_op_cuda(h0, x0, w_ih, w_hh, b, fc2_w, fc2_b, table,
                      max_length: int) -> torch.Tensor:
    K.check(max_length >= 1, GENERATE.name, "needs max_length >= 1")
    return _generate_kernel(DecodeWeights(CellWeights(w_ih, w_hh, b), table,
                                          x0, fc2_w, fc2_b), h0, max_length)


def _generate_op_cpu(h0, x0, w_ih, w_hh, b, fc2_w, fc2_b, table,
                     max_length: int) -> torch.Tensor:
    """`greedy_generate_plain` on the question encoder's params that the
    decode's weights hold: the cast LSTM layer, the embedding table, and
    the head without its padding (x0 is the loop's own first step)."""
    vocab = table.shape[0]
    params = {"lstm": {"layers": [{"cell": CellWeights(w_ih, w_hh, b)}]},
              "word2vec": {"table": table},
              "fc2": {"w": fc2_w[:, :vocab], "b": fc2_b[:vocab]}}
    return greedy_generate_plain(params, h0, max_length, w_ih.dtype)


def _fake_generate(h0, x0, w_ih, w_hh, b, fc2_w, fc2_b, table,
                   max_length: int) -> torch.Tensor:
    name = GENERATE.name
    K.check(max_length >= 1, name, "needs max_length >= 1")
    vocab, emb = table.shape
    hid = w_hh.shape[0]
    vpad = fc2_w.shape[1]
    K.dtype_code(name, w_ih.dtype)
    K.check(w_ih.shape == (emb, 4 * hid) and w_hh.shape == (hid, 4 * hid)
            and w_hh.dtype == w_ih.dtype and b.shape == (4 * hid,)
            and b.dtype == f32, name,
            f"the LSTM weights must be w_ih [{emb}, {4 * hid}], w_hh "
            f"[{hid}, {4 * hid}] of one dtype and b [{4 * hid}] float32")
    K.check(h0.dim() == 2 and h0.shape[1] == hid, name,
            f"image embedding must be [B, {hid}] (h0 = c0)")
    K.check(x0.shape == (emb,) and table.dtype == f32 and x0.dtype == f32,
            name, f"x0 must be [{emb}] and the table [V, {emb}], float32")
    K.check(fc2_w.shape[0] == hid and fc2_w.dtype == w_ih.dtype
            and vpad % 8 == 0 and 0 <= vpad - vocab < 8
            and fc2_b.shape == (vpad,) and fc2_b.dtype == f32, name,
            f"fc2 must map {hid} -> {vocab}, padded to a multiple of 8")
    return h0.new_empty((h0.shape[0], max_length), dtype=torch.int32)


GREEDY_GENERATE_OP = K.define_op(
    "greedy_generate(Tensor h0, Tensor x0, Tensor w_ih, Tensor w_hh, "
    "Tensor b, Tensor fc2_w, Tensor fc2_b, Tensor table, int max_length) "
    "-> Tensor",
    _generate_op_cuda, _generate_op_cpu, _fake_generate)


def greedy_generate(qst_params, image_embedding: torch.Tensor,
                    max_length: int,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Fused greedy decode (replaces greedy_generate_pallas).
    image_embedding [B, H]; returns int32 tokens [B, max_length]. It is
    the `greedy_generate` operator (tokens carry no gradient; the kernel
    shares nothing across ranks)."""
    d = decode_weights(qst_params, dtype)
    if image_embedding.device.type not in K.OP_DEVICES:
        return _generate_kernel(d, image_embedding, max_length)  # raises
    h0 = image_embedding.reshape(image_embedding.shape[0], -1).to(f32)
    return GREEDY_GENERATE_OP(h0, d.x0, *d.cell, d.fc2_w, d.fc2_b, d.table,
                              max_length)


def _generate_kernel(d: DecodeWeights, image_embedding: torch.Tensor,
                     max_length: int) -> torch.Tensor:
    """The kernel on weights that `decode_weights` cast: checks, the launch
    shape (raises where the card cannot hold the grid), one zeroed scratch,
    one launch."""
    name = GENERATE.name
    w = d.cell
    bsz = image_embedding.shape[0]
    h0 = image_embedding.reshape(bsz, -1).to(f32).contiguous()
    device = K.check_cuda_tensors(name, h0=h0, w_ih=w.w_ih, w_hh=w.w_hh,
                                  fc2_w=d.fc2_w, table=d.table)
    vocab, emb = d.table.shape
    hid = w.w_hh.shape[0]
    vpad = d.fc2_w.shape[1]
    code = K.dtype_code(name, w.w_ih.dtype)
    K.check(w.w_ih.shape == (emb, 4 * hid), name,
            f"w_ih must be [{emb}, {4 * hid}]")
    K.check(h0.shape == (bsz, hid), name,
            f"image embedding must be [{bsz}, {hid}] (h0 = c0)")
    K.check(d.fc2_w.shape[0] == hid and vpad % 8 == 0
            and 0 <= vpad - vocab < 8 and d.fc2_b.shape == (vpad,), name,
            f"fc2 must map {hid} -> {vocab}, padded to a multiple of 8")
    K.check(d.fc2_w.is_contiguous() and d.fc2_w.data_ptr() % 16 == 0
            and d.fc2_b.data_ptr() % 16 == 0, name,
            "fc2 weight and bias must be contiguous and 16-byte aligned")
    generate_plan(emb, hid, vpad, w.w_ih.dtype, _sm_count(device.index))
    tokens = torch.empty(bsz, max_length, dtype=torch.int32, device=device)
    if bsz:
        # per-call scratch: calls on several streams share nothing
        scratch = torch.zeros(
            generate_scratch_bytes(bsz, max_length, hid, w.w_ih.dtype),
            dtype=torch.uint8, device=device)
        GENERATE.launch(device, h0, d.x0, w.w_ih, w.w_hh, w.b, d.fc2_w,
                        d.fc2_b, d.table, tokens, scratch, bsz, max_length,
                        emb, hid, vpad, code)
    return tokens
