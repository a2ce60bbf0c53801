"""LSTM kernels: the fused cell and the two whole-sequence recurrences.

Counterpart of `lctvqa/ops/pallas_lstm.py`; the kernels are in
`lctvqa_torch/csrc/lstm.cu`. Each public function has a plain PyTorch
version beside it (`*_plain`) that computes the same thing the way the
kernel's numerics are defined: operands rounded to the compute dtype,
then every product and sum in fp32 (which is exactly what a bf16 x bf16
-> fp32 product does). The wrapper takes the plain version only for CPU
tensors; for CUDA tensors it launches the kernel or raises.

The compute dtype is that of the weights in `CellWeights`; c and h
state, bias and outputs are fp32. `cell_weights` checks a layer's weights
once, where it casts them; the cell's wrapper then checks only what
changes from call to call.

The cell is one launch of ceil(H / U) blocks (`cell_plan`; U = 8 hidden
units in bf16, 4 in fp32): each block keeps its [E + H, 4U] slice of
the weights in shared memory, takes the
batch as the M dimension in tiles of up to 64 rows (`cell_batch_tiles`)
and writes h' and c' into one [2, B, H] output. It takes x in fp32 or in
the compute dtype, with any row stride, and rounds it itself.

The two whole-sequence functions are one kernel pair: a tiled product
writes x W_ih + b for all steps at once into an fp32 scratch, then one
persistent kernel runs the T steps with each block's slice of W_hh
resident in shared memory, the recurrent product on the tensor cores in
bf16, and one grid barrier per step (`seq_plan`, `seq_scratch_bytes`). All
its blocks must be resident at once, so the launch is cooperative: a card
too small for the grid makes the wrapper raise.

Gradients: the JAX package has no backward kernel for these three; its
derivative is a tangent rule in plain array code that recomputes the
gates. Here `LstmCellFn`, `LstmSeqFinalFn` and `LstmSeqFn` launch the
kernel forward and take the gradient by autograd through the plain
version on the same rounded operands, recomputed in the backward. First
order only. A call that needs no gradient is one of the operators
`lctvqa_torch::lstm_cell`, `lstm_seq_final` and `lstm_seq`
(`_build.define_op`), on either device: these kernels share nothing
across ranks, so a process group changes nothing of their route.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from lctvqa_torch.ops import _build as K

Tensor = torch.Tensor
f32 = torch.float32

CELL = K.register(K.Kernel("lstm_cell", "lctvqa_lstm_cell",
                           [K.PTR, K.LONG, K.INT] + [K.PTR] * 6
                           + [K.INT] * 4))
SEQ_FINAL = K.register(K.Kernel("lstm_seq_final", "lctvqa_lstm_seq",
                                [K.PTR] * 11 + [K.INT] * 5))
SEQ_ALL = K.register(K.Kernel("lstm_seq_all", "lctvqa_lstm_seq",
                              [K.PTR] * 11 + [K.INT] * 5))

# the cell kernel's launch shape (csrc/lstm.cu, namespace cell): hidden
# units per block by compute dtype
CELL_THREADS = 512
CELL_UNITS = {torch.bfloat16: 8, torch.float32: 4}
CELL_WARPS = CELL_THREADS // 32
# the sequence kernel's launch shape (csrc/lstm_seq.cuh)
SEQ_THREADS = 512
SEQ_SYNC_BYTES = 256        # the grid barrier's counter, padded
SMEM_PER_BLOCK = 232448     # what a block may take on sm_90


class CellWeights(NamedTuple):
    """One layer's weights as the kernels take them."""

    w_ih: Tensor  # [E, 4H], compute dtype
    w_hh: Tensor  # [H, 4H], compute dtype
    b: Tensor     # [4H] fp32, b_ih + b_hh


def cell_weights(layer_params, dtype: Optional[torch.dtype]) -> CellWeights:
    """Cast one layer's params ({"w_ih", "w_hh", "b_ih", "b_hh"}) once,
    outside the time loop, and check them (`check_cell_weights`). dtype
    None keeps fp32. A layer that holds its cast weights under "cell" (a
    served model's, checked where it was cast) returns them."""
    dt = dtype or f32
    if "cell" in layer_params:
        cell = layer_params["cell"]
        if cell.w_ih.dtype != dt:
            raise ValueError(f"layer weights cast to {cell.w_ih.dtype}, "
                             f"called with {dt}")
        return cell
    w = CellWeights(
        layer_params["w_ih"].to(dt).contiguous(),
        layer_params["w_hh"].to(dt).contiguous(),
        (layer_params["b_ih"].to(f32) + layer_params["b_hh"].to(f32))
        .contiguous())
    check_cell_weights(w)
    return w


def check_cell_weights(w: CellWeights) -> None:
    """What the kernels take of a layer's weights, whatever the device: w_ih
    [E, 4H] and w_hh [H, 4H] of one dtype, b [4H] fp32, all contiguous and
    on one device. Raises ValueError otherwise."""
    name = CELL.name
    hid = w.w_hh.shape[0]
    K.check(w.w_ih.dim() == 2 and w.w_ih.shape[1] == 4 * hid, name,
            f"w_ih must be [E, {4 * hid}], got {tuple(w.w_ih.shape)}")
    K.check(w.w_hh.shape == (hid, 4 * hid), name,
            f"w_hh must be [{hid}, {4 * hid}], got {tuple(w.w_hh.shape)}")
    K.check(w.b.shape == (4 * hid,) and w.b.dtype == f32, name,
            "b must be [4H] float32")
    K.check(w.w_hh.dtype == w.w_ih.dtype, name,
            "w_ih and w_hh must share one compute dtype")
    K.check(all(t.is_contiguous() for t in w), name,
            "weights must be contiguous")
    K.check(w.w_ih.device == w.w_hh.device == w.b.device, name,
            "weights must be on one device")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def lstm_cell_plain(w: CellWeights, x: Tensor, h: Tensor,
                    c: Tensor) -> Tuple[Tensor, Tensor]:
    """x [B, E], h/c [B, H] -> (h', c') fp32. Gate order i, f, g, o."""
    cdt = w.w_ih.dtype
    gates = (x.to(cdt).to(f32) @ w.w_ih.to(f32)
             + h.to(cdt).to(f32) @ w.w_hh.to(f32) + w.b)
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c.to(f32) + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def _zeros_state(w: CellWeights, xs: Tensor, h0, c0):
    b, hid = xs.shape[0], w.w_hh.shape[0]
    if h0 is None:
        h0 = torch.zeros(b, hid, dtype=f32, device=xs.device)
    if c0 is None:
        c0 = torch.zeros(b, hid, dtype=f32, device=xs.device)
    return h0.to(f32), c0.to(f32)


def lstm_seq_plain(w: CellWeights, xs: Tensor, h0: Optional[Tensor] = None,
                   c0: Optional[Tensor] = None):
    """xs [B, T, E] -> (outputs [B, T, H], (h_n, c_n) [B, H]), all fp32."""
    h, c = _zeros_state(w, xs, h0, c0)
    outs = []
    for t in range(xs.shape[1]):
        h, c = lstm_cell_plain(w, xs[:, t], h, c)
        outs.append(h)
    return torch.stack(outs, 1), (h, c)


def lstm_seq_final_plain(w: CellWeights, xs: Tensor,
                         h0: Optional[Tensor] = None,
                         c0: Optional[Tensor] = None):
    """xs [B, T, E] -> the final (h_n, c_n) [B, H] fp32."""
    return lstm_seq_plain(w, xs, h0, c0)[1]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_weights(name: str, w: CellWeights, emb: int) -> Tuple[int, int]:
    check_cell_weights(w)
    hid = w.w_hh.shape[0]
    K.check(w.w_ih.shape[0] == emb, name,
            f"w_ih must be [{emb}, {4 * hid}], got {tuple(w.w_ih.shape)}")
    # bounds that keep the sequence kernel's grid within one block per SM
    K.check(emb + 4 * hid <= 8192 and hid <= 1024, name,
            f"E={emb}, H={hid} too large (needs E + 4H <= 8192, H <= 1024)")
    return hid, K.dtype_code(name, w.w_ih.dtype)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


@functools.lru_cache(maxsize=None)
def cell_plan(emb: int, hid: int, dtype: torch.dtype,
              smem_max: int = SMEM_PER_BLOCK) -> dict:
    """The cell kernel's launch shape at (E, H), as the C entry point
    chooses it: ceil(H / U) blocks of 512 threads, each owning U hidden
    units (8 in bf16, 4 in fp32; 4U gate columns) with its [KP, 4U] slice
    of [W_ih; W_hh] in shared memory, KP = (E rounded up to 16) + H
    rounded up to 16 (bf16, the mma's depth) or 64 (fp32, 16 slices of
    whole float4 steps); the largest batch tile (bf16 64, 32, 16 rows;
    fp32 32, 16) whose shared memory fits `smem_max`. Raises ValueError
    where none does."""
    code = K.dtype_code(CELL.name, dtype)
    mma = dtype == torch.bfloat16
    size = 2 if mma else 4
    units = CELL_UNITS[dtype]
    cols = 4 * units
    kp = _round_up(_round_up(emb, 16) + hid, 16 if mma else 64)
    w_stride = cols + 8 if mma else cols
    for tile in ((64, 32, 16) if mma else (32, 16)):
        partial = CELL_WARPS * (16 if mma else tile) * cols * 4
        smem = partial + (kp * w_stride + tile * (kp + 16 // size)) * size
        if smem <= smem_max:
            return {"units": units, "blocks": -(-hid // units),
                    "threads": CELL_THREADS, "batch_tile": tile,
                    "smem_bytes": smem, "code": code}
    raise ValueError(f"lstm_cell: E={emb}, H={hid} too large: the weight "
                     f"slice and a 16-row batch tile need more than "
                     f"{smem_max} bytes of shared memory in {dtype}")


def cell_batch_tiles(bsz: int, tile: int):
    """The batch tiles one cell block runs in turn, weights resident:
    [(first row, rows)]."""
    return [(b0, min(tile, bsz - b0)) for b0 in range(0, bsz, tile)]


def cell_plan_on_device(emb: int, hid: int, dtype: torch.dtype,
                        device: torch.device) -> dict:
    """The launch shape the C entry point takes on `device` (it asks the
    card for its shared-memory limit): `cell_plan`'s keys without code."""
    import ctypes

    fn = K.library().lctvqa_lstm_cell_plan
    fn.argtypes = [K.INT, K.INT, K.INT, ctypes.POINTER(K.INT * 4)]
    fn.restype = K.INT
    plan = (K.INT * 4)()
    with torch.cuda.device(device):
        rc = fn(emb, hid, K.dtype_code("lstm_cell", dtype), ctypes.byref(plan))
    if rc != 0:
        msg = K.library().lctvqa_cuda_error_string(rc).decode()
        raise RuntimeError(f"lstm_cell: no launch shape for E={emb}, H={hid} "
                           f"in {dtype} on {device}: {msg} (cudaError {rc})")
    units, blocks, tile, smem = plan
    return {"units": units, "blocks": blocks, "threads": CELL_THREADS,
            "batch_tile": tile, "smem_bytes": smem}


def seq_plan(hid: int, dtype: torch.dtype, sm_count: int) -> dict:
    """The sequence kernel's launch shape at hidden size `hid` on a card
    of `sm_count` SMs, as the C entry point chooses it: one block per SM
    at most, each owning `units` hidden units (all four gates) with its
    [H, 4 units] slice of W_hh in shared memory. bf16 takes 8 units (one
    tensor-core tile of 8 columns per gate); fp32 takes 4 with a 64-row
    batch tile where that many blocks fit on the card and the tile in
    shared memory beside the weights, else 8 with a 16-row tile.
    `batch_tile` rows are multiplied at a time, `k_slices` warps or warp
    groups share the sum over H. Raises ValueError where no shape fits."""
    mma = dtype == torch.bfloat16
    size = 2 if mma else 4
    hp = _round_up(hid, 128 if mma else 64)
    stride = hp + 16 // size
    k_slices = 4 if mma else 16
    # (units, rows a thread multiplies), in the order the kernel tries them
    for units, rows in (((8, 4),) if mma else ((4, 8), (8, 4))):
        tile = 64 if mma else rows * 32 // units
        w_elems = 4 * units * stride if mma else hp * 4 * units
        smem = (k_slices * tile * 4 * units * 4
                + (w_elems + tile * stride) * size)
        blocks = -(-hid // units)
        if blocks <= sm_count and smem <= SMEM_PER_BLOCK:
            return {"units": units, "blocks": blocks, "threads": SEQ_THREADS,
                    "smem_bytes": smem, "batch_tile": tile,
                    "k_slices": k_slices}
    raise ValueError(f"lstm_seq: H={hid} in {dtype} needs more than "
                     f"{sm_count} resident blocks or {SMEM_PER_BLOCK} bytes "
                     "of shared memory per block")


def seq_scratch_bytes(bsz: int, hid: int, dtype: torch.dtype) -> int:
    """Bytes of zeroed scratch one sequence call needs: the barrier's
    counter, then the exchange buffer [2, B, H rounded up to 8] of the
    compute dtype (rows start on 16 bytes)."""
    size = 2 if dtype == torch.bfloat16 else 4
    return SEQ_SYNC_BYTES + 2 * bsz * _round_up(hid, 8) * size


def seq_plan_on_device(hid: int, dtype: torch.dtype,
                       device: torch.device) -> dict:
    """The launch shape the C entry point takes on `device` (it asks the
    card for its SMs, shared memory and occupancy): `seq_plan`'s keys
    without k_slices. Raises where the grid cannot be resident at once."""
    import ctypes

    fn = K.library().lctvqa_lstm_seq_plan
    fn.argtypes = [K.INT, K.INT, ctypes.POINTER(K.INT * 4)]
    fn.restype = K.INT
    plan = (K.INT * 4)()
    with torch.cuda.device(device):
        rc = fn(hid, K.dtype_code("lstm_seq", dtype), ctypes.byref(plan))
    if rc != 0:
        msg = K.library().lctvqa_cuda_error_string(rc).decode()
        raise RuntimeError(f"lstm_seq: no launch shape for H={hid} in "
                           f"{dtype} on {device}: {msg} (cudaError {rc})")
    units, tile, blocks, smem = plan
    return {"units": units, "blocks": blocks, "threads": SEQ_THREADS,
            "smem_bytes": smem, "batch_tile": tile}


# `barriers` empty grid barriers of `blocks` blocks: the floor under a
# recurrence's chain of steps. A diagnostic, not a kernel of any path.
_BARRIER_PROBE = K.Kernel("grid_barrier_probe", "lctvqa_grid_barrier_probe",
                          [K.PTR, K.INT, K.INT])


def grid_barrier_probe(blocks: int, barriers: int,
                       device: torch.device) -> None:
    counter = torch.zeros(SEQ_SYNC_BYTES, dtype=torch.uint8, device=device)
    _BARRIER_PROBE.launch(device, counter, blocks, barriers)


def _cell_kernel(w: CellWeights, x: Tensor, h: Tensor,
                 c: Tensor) -> Tuple[Tensor, Tensor]:
    return _cell_out(w, x, h, c).unbind(0)


def _cell_out(w: CellWeights, x: Tensor, h: Tensor, c: Tensor) -> Tensor:
    """The cell kernel on weights that `cell_weights` checked: per call only
    devices, shapes and the layout of x, h and c are looked at, and a cast
    or copy is made only where one is needed. -> h' and c' as one fp32
    [2, B, H], the kernel's output."""
    w_ih = w.w_ih
    device = w_ih.device
    if not (device.type == "cuda" and x.device == device
            and h.device == device and c.device == device):
        K.check_cuda_tensors(CELL.name, x=x, h=h, c=c, w_ih=w_ih)
    bsz, emb = x.shape
    hid = w.w_hh.shape[0]
    if w_ih.shape[0] != emb or h.shape != (bsz, hid) or c.shape != (bsz, hid):
        raise ValueError(f"lstm_cell: x [{bsz}, {emb}], h {tuple(h.shape)} "
                         f"and c {tuple(c.shape)} do not fit w_ih "
                         f"{tuple(w_ih.shape)}, w_hh {tuple(w.w_hh.shape)}")
    plan = cell_plan(emb, hid, w_ih.dtype)
    x_code = K.DTYPE_CODES.get(x.dtype)
    if x_code is None or x.stride(1) != 1:
        x, x_code = x.to(f32).contiguous(), K.DTYPE_CODES[f32]
    if h.dtype != f32 or not h.is_contiguous():
        h = h.to(f32).contiguous()
    if c.dtype != f32 or not c.is_contiguous():
        c = c.to(f32).contiguous()
    out = torch.empty((2, bsz, hid), dtype=f32, device=device)
    if bsz:
        CELL.launch(device, x, x.stride(0), x_code, h, c, w_ih, w.w_hh, w.b,
                    out, bsz, emb, hid, plan["code"])
    return out


def _seq(kernel: K.Kernel, w: CellWeights, xs: Tensor, h0, c0,
         with_outputs: bool):
    name = kernel.name
    h0, c0 = _zeros_state(w, xs, h0, c0)
    device = K.check_cuda_tensors(name, xs=xs, h0=h0, c0=c0, w_ih=w.w_ih,
                                  w_hh=w.w_hh, b=w.b)
    bsz, steps, emb = xs.shape
    hid, code = _check_weights(name, w, emb)
    K.check(steps >= 1, name, "needs at least one time step")
    K.check(h0.shape == (bsz, hid) and c0.shape == (bsz, hid), name,
            f"h0 and c0 must be [{bsz}, {hid}]")
    xs = xs.to(w.w_ih.dtype).contiguous()
    h0, c0 = h0.contiguous(), c0.contiguous()
    out = (torch.empty(bsz, steps, hid, dtype=f32, device=device)
           if with_outputs else None)
    h_n = torch.empty(bsz, hid, dtype=f32, device=device)
    c_n = torch.empty(bsz, hid, dtype=f32, device=device)
    if bsz:
        # per-call scratch: calls on several streams share nothing
        xw = torch.empty(bsz, steps, 4 * hid, dtype=f32, device=device)
        scratch = torch.zeros(seq_scratch_bytes(bsz, hid, w.w_ih.dtype),
                              dtype=torch.uint8, device=device)
        kernel.launch(device, xs, h0, c0, w.w_ih, w.w_hh, w.b,
                      out if with_outputs else None, h_n, c_n, xw, scratch,
                      bsz, steps, emb, hid, code)
    return out, (h_n, c_n)


def _plain_grad_fn(name: str, kernel, plain):
    """An autograd.Function over (x, h, c, w_ih, w_hh, b): forward is
    `kernel` (`plain` for CPU tensors), backward is autograd through
    `plain` on the same inputs. Both take (CellWeights, x, h, c) and
    return a flat tuple of tensors."""

    def forward(ctx, x, h, c, w_ih, w_hh, b):
        ctx.save_for_backward(x, h, c, w_ih, w_hh, b)
        fn = plain if x.device.type == "cpu" else kernel
        return fn(CellWeights(w_ih, w_hh, b), x, h, c)

    @once_differentiable
    def backward(ctx, *grads):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            x, h, c, w_ih, w_hh, b = ins
            outs = plain(CellWeights(w_ih, w_hh, b), x, h, c)
            return torch.autograd.grad(outs, ins, grads)

    return type(name, (torch.autograd.Function,),
                {"forward": staticmethod(forward),
                 "backward": staticmethod(backward), "__doc__": (
                     f"{kernel.__name__} forward, autograd through "
                     f"{plain.__name__} backward.")})


def _seq_final_kernel(w, xs, h0, c0):
    return _seq(SEQ_FINAL, w, xs, h0, c0, with_outputs=False)[1]


def _seq_all_kernel(w, xs, h0, c0):
    out, (h_n, c_n) = _seq(SEQ_ALL, w, xs, h0, c0, with_outputs=True)
    return out, h_n, c_n


def _seq_all_plain(w, xs, h0, c0):
    out, (h_n, c_n) = lstm_seq_plain(w, xs, h0, c0)
    return out, h_n, c_n


LstmCellFn = _plain_grad_fn("LstmCellFn", _cell_kernel, lstm_cell_plain)
LstmSeqFinalFn = _plain_grad_fn("LstmSeqFinalFn", _seq_final_kernel,
                                lstm_seq_final_plain)
LstmSeqFn = _plain_grad_fn("LstmSeqFn", _seq_all_kernel, _seq_all_plain)


# ---------------------------------------------------------------------------
# the operators: a served call's route (no gradient)
# ---------------------------------------------------------------------------

def _fake_weights(name: str, emb: int, w_ih: Tensor, w_hh: Tensor,
                  b: Tensor) -> int:
    """What the kernels check of a layer's weights, shapes and dtypes only
    -> H."""
    hid = w_hh.shape[0]
    K.check(w_ih.shape == (emb, 4 * hid) and w_hh.shape == (hid, 4 * hid)
            and b.shape == (4 * hid,) and b.dtype == f32, name,
            f"weights must be w_ih [{emb}, {4 * hid}], w_hh [{hid}, "
            f"{4 * hid}] and b [{4 * hid}] float32, got "
            f"{tuple(w_ih.shape)}, {tuple(w_hh.shape)}, {tuple(b.shape)}")
    K.check(w_hh.dtype == w_ih.dtype, name,
            "w_ih and w_hh must share one compute dtype")
    K.dtype_code(name, w_ih.dtype)
    return hid


def _fake_cell(x, h, c, w_ih, w_hh, b):
    K.check(x.dim() == 2, CELL.name, f"x must be [B, E], got {tuple(x.shape)}")
    bsz, emb = x.shape
    hid = _fake_weights(CELL.name, emb, w_ih, w_hh, b)
    K.check(h.shape == (bsz, hid) and c.shape == (bsz, hid), CELL.name,
            f"h and c must be [{bsz}, {hid}]")
    if isinstance(emb, int) and isinstance(hid, int):  # not symbolic
        cell_plan(emb, hid, w_ih.dtype)
    return x.new_empty((2, bsz, hid), dtype=f32)


def _fake_seq(name, xs, h0, c0, w_ih, w_hh, b):
    K.check(xs.dim() == 3, name, f"xs must be [B, T, E], got "
            f"{tuple(xs.shape)}")
    bsz, steps, emb = xs.shape
    hid = _fake_weights(name, emb, w_ih, w_hh, b)
    K.check(emb + 4 * hid <= 8192 and hid <= 1024, name,
            f"E={emb}, H={hid} too large (needs E + 4H <= 8192, H <= 1024)")
    K.check(steps >= 1, name, "needs at least one time step")
    K.check(h0.shape == (bsz, hid) and c0.shape == (bsz, hid), name,
            f"h0 and c0 must be [{bsz}, {hid}]")
    return [xs.new_empty((bsz, hid), dtype=f32) for _ in range(2)]


def _seq_final_op_cpu(xs, h0, c0, w_ih, w_hh, b):
    h_n, c_n = lstm_seq_final_plain(CellWeights(w_ih, w_hh, b), xs, h0, c0)
    return K.fresh(h_n, h0, c0), K.fresh(c_n, h0, c0)


def _seq_op_cpu(xs, h0, c0, w_ih, w_hh, b):
    out, h_n, c_n = _seq_all_plain(CellWeights(w_ih, w_hh, b), xs, h0, c0)
    return out, K.fresh(h_n, h0, c0), K.fresh(c_n, h0, c0)


def _fake_seq_all(xs, h0, c0, w_ih, w_hh, b):
    h_n, c_n = _fake_seq(SEQ_ALL.name, xs, h0, c0, w_ih, w_hh, b)
    return xs.new_empty((*xs.shape[:2], w_hh.shape[0]), dtype=f32), h_n, c_n


_W = "Tensor w_ih, Tensor w_hh, Tensor b"
# one [2, B, H] output, h' then c': the kernel writes both into one
# allocation, and an operator's outputs may not share memory
LSTM_CELL_OP = K.define_op(
    f"lstm_cell(Tensor x, Tensor h, Tensor c, {_W}) -> Tensor",
    lambda x, h, c, *w: _cell_out(CellWeights(*w), x, h, c),
    lambda x, h, c, *w: torch.stack(lstm_cell_plain(CellWeights(*w), x, h,
                                                    c)),
    _fake_cell)
LSTM_SEQ_FINAL_OP = K.define_op(
    f"lstm_seq_final(Tensor xs, Tensor h0, Tensor c0, {_W}) "
    "-> (Tensor, Tensor)",
    lambda xs, h0, c0, *w: _seq_final_kernel(CellWeights(*w), xs, h0, c0),
    _seq_final_op_cpu,
    lambda *a: tuple(_fake_seq(SEQ_FINAL.name, *a)))
LSTM_SEQ_OP = K.define_op(
    f"lstm_seq(Tensor xs, Tensor h0, Tensor c0, {_W}) "
    "-> (Tensor, Tensor, Tensor)",
    lambda xs, h0, c0, *w: _seq_all_kernel(CellWeights(*w), xs, h0, c0),
    _seq_op_cpu, _fake_seq_all)


# ---------------------------------------------------------------------------
# the public functions
# ---------------------------------------------------------------------------

def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def lstm_cell(w: CellWeights, x: Tensor, h: Tensor,
              c: Tensor) -> Tuple[Tensor, Tensor]:
    """One LSTM step (replaces lstm_cell_pallas), differentiable once.
    x [B, E], h/c [B, H]. A call that needs no gradient is the
    `lstm_cell` operator."""
    if x.device.type in K.OP_DEVICES and not _needs_grad(x, h, c, *w):
        return LSTM_CELL_OP(x, h, c, *w).unbind(0)
    if x.device.type == "cpu":
        return lstm_cell_plain(w, x, h, c)
    return LstmCellFn.apply(x, h, c, *w)


def lstm_seq_final(w: CellWeights, xs: Tensor, h0: Optional[Tensor] = None,
                   c0: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Whole recurrence, final state only (replaces lstm_seq_final_pallas),
    differentiable once. xs [B, T, E]; h0/c0 [B, H] or None (zeros).
    -> (h_n, c_n) fp32. A call that needs no gradient is the
    `lstm_seq_final` operator."""
    h0, c0 = _zeros_state(w, xs, h0, c0)
    if xs.device.type in K.OP_DEVICES and not _needs_grad(xs, h0, c0, *w):
        return LSTM_SEQ_FINAL_OP(xs, h0, c0, *w)
    if xs.device.type == "cpu":
        return lstm_seq_final_plain(w, xs, h0, c0)
    return LstmSeqFinalFn.apply(xs, h0, c0, *w)


def lstm_seq(w: CellWeights, xs: Tensor, h0: Optional[Tensor] = None,
             c0: Optional[Tensor] = None):
    """Whole recurrence with every step's h (replaces lstm_seq_pallas),
    differentiable once. -> (outputs [B, T, H], (h_n, c_n) [B, H]), all
    fp32. A call that needs no gradient is the `lstm_seq` operator."""
    h0, c0 = _zeros_state(w, xs, h0, c0)
    if xs.device.type in K.OP_DEVICES and not _needs_grad(xs, h0, c0, *w):
        out, h_n, c_n = LSTM_SEQ_OP(xs, h0, c0, *w)
    elif xs.device.type == "cpu":
        return lstm_seq_plain(w, xs, h0, c0)
    else:
        out, h_n, c_n = LstmSeqFn.apply(xs, h0, c0, *w)
    return out, (h_n, c_n)
