"""LSTM kernels: the fused cell and the two whole-sequence recurrences.

Counterpart of `lctvqa/ops/pallas_lstm.py`; the kernels are in
`lctvqa_torch/csrc/lstm.cu`. Each public function has a plain PyTorch
version beside it (`*_plain`) that computes the same thing the way the
kernel's numerics are defined: operands rounded to the compute dtype,
then every product and sum in fp32 (which is exactly what a bf16 x bf16
-> fp32 product does). The wrapper takes the plain version only for CPU
tensors; for CUDA tensors it launches the kernel or raises.

The compute dtype is that of the weights in `CellWeights`; c and h
state, bias and outputs are fp32.

Gradients: the JAX package has no backward kernel for these three; its
derivative is a tangent rule in plain array code that recomputes the
gates. Here `LstmCellFn`, `LstmSeqFinalFn` and `LstmSeqFn` launch the
kernel forward and take the gradient by autograd through the plain
version on the same rounded operands, recomputed in the backward. First
order only.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from lctvqa_torch.ops import _build as K

Tensor = torch.Tensor
f32 = torch.float32

CELL = K.register(K.Kernel("lstm_cell", "lctvqa_lstm_cell",
                           [K.PTR] * 8 + [K.INT] * 4))
SEQ_FINAL = K.register(K.Kernel("lstm_seq_final", "lctvqa_lstm_seq",
                                [K.PTR] * 9 + [K.INT] * 5))
SEQ_ALL = K.register(K.Kernel("lstm_seq_all", "lctvqa_lstm_seq",
                              [K.PTR] * 9 + [K.INT] * 5))


class CellWeights(NamedTuple):
    """One layer's weights as the kernels take them."""

    w_ih: Tensor  # [E, 4H], compute dtype
    w_hh: Tensor  # [H, 4H], compute dtype
    b: Tensor     # [4H] fp32, b_ih + b_hh


def cell_weights(layer_params, dtype: Optional[torch.dtype]) -> CellWeights:
    """Cast one layer's params ({"w_ih", "w_hh", "b_ih", "b_hh"}) once,
    outside the time loop. dtype None keeps fp32. A layer that holds its
    cast weights under "cell" (a served model's) returns them."""
    dt = dtype or f32
    if "cell" in layer_params:
        cell = layer_params["cell"]
        if cell.w_ih.dtype != dt:
            raise ValueError(f"layer weights cast to {cell.w_ih.dtype}, "
                             f"called with {dt}")
        return cell
    return CellWeights(
        layer_params["w_ih"].to(dt).contiguous(),
        layer_params["w_hh"].to(dt).contiguous(),
        (layer_params["b_ih"].to(f32) + layer_params["b_hh"].to(f32))
        .contiguous())


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
    hid = w.w_hh.shape[0]
    K.check(w.w_ih.shape == (emb, 4 * hid), name,
            f"w_ih must be [{emb}, {4 * hid}], got {tuple(w.w_ih.shape)}")
    K.check(w.w_hh.shape == (hid, 4 * hid), name,
            f"w_hh must be [{hid}, {4 * hid}], got {tuple(w.w_hh.shape)}")
    K.check(w.b.shape == (4 * hid,) and w.b.dtype == f32, name,
            "b must be [4H] float32")
    K.check(w.w_hh.dtype == w.w_ih.dtype, name,
            "w_ih and w_hh must share one compute dtype")
    K.check(all(t.is_contiguous() for t in w), name,
            "weights must be contiguous")
    # bounds that keep the kernels' shared memory under 48 KB and a row
    # of units within one block
    K.check(emb + 4 * hid <= 8192 and hid <= 1024, name,
            f"E={emb}, H={hid} too large (needs E + 4H <= 8192, H <= 1024)")
    return hid, K.dtype_code(name, w.w_ih.dtype)


def _cell_kernel(w: CellWeights, x: Tensor, h: Tensor,
                 c: Tensor) -> Tuple[Tensor, Tensor]:
    name = CELL.name
    device = K.check_cuda_tensors(name, x=x, h=h, c=c, w_ih=w.w_ih,
                                  w_hh=w.w_hh, b=w.b)
    bsz, emb = x.shape
    hid, code = _check_weights(name, w, emb)
    K.check(h.shape == (bsz, hid) and c.shape == (bsz, hid), name,
            f"h and c must be [{bsz}, {hid}]")
    x = x.to(w.w_ih.dtype).contiguous()
    h = h.to(f32).contiguous()
    c = c.to(f32).contiguous()
    h_out = torch.empty(bsz, hid, dtype=f32, device=device)
    c_out = torch.empty(bsz, hid, dtype=f32, device=device)
    if bsz:
        CELL.launch(device, x, h, c, w.w_ih, w.w_hh, w.b, h_out, c_out,
                    bsz, emb, hid, code)
    return h_out, c_out


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
        kernel.launch(device, xs, h0, c0, w.w_ih, w.w_hh, w.b,
                      out if with_outputs else None, h_n, c_n,
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


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def lstm_cell(w: CellWeights, x: Tensor, h: Tensor,
              c: Tensor) -> Tuple[Tensor, Tensor]:
    """One LSTM step (replaces lstm_cell_pallas), differentiable once.
    x [B, E], h/c [B, H]."""
    if x.device.type == "cpu":
        return lstm_cell_plain(w, x, h, c)
    if _needs_grad(x, h, c, *w):
        return LstmCellFn.apply(x, h, c, *w)
    return _cell_kernel(w, x, h, c)


def lstm_seq_final(w: CellWeights, xs: Tensor, h0: Optional[Tensor] = None,
                   c0: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Whole recurrence, final state only (replaces lstm_seq_final_pallas),
    differentiable once. xs [B, T, E]; h0/c0 [B, H] or None (zeros).
    -> (h_n, c_n) fp32."""
    if xs.device.type == "cpu":
        return lstm_seq_final_plain(w, xs, h0, c0)
    h0, c0 = _zeros_state(w, xs, h0, c0)
    if _needs_grad(xs, h0, c0, *w):
        return LstmSeqFinalFn.apply(xs, h0, c0, *w)
    return _seq_final_kernel(w, xs, h0, c0)


def lstm_seq(w: CellWeights, xs: Tensor, h0: Optional[Tensor] = None,
             c0: Optional[Tensor] = None):
    """Whole recurrence with every step's h (replaces lstm_seq_pallas),
    differentiable once. -> (outputs [B, T, H], (h_n, c_n) [B, H]), all
    fp32."""
    if xs.device.type == "cpu":
        return lstm_seq_plain(w, xs, h0, c0)
    h0, c0 = _zeros_state(w, xs, h0, c0)
    if _needs_grad(xs, h0, c0, *w):
        out, h_n, c_n = LstmSeqFn.apply(xs, h0, c0, *w)
    else:
        out, h_n, c_n = _seq_all_kernel(w, xs, h0, c0)
    return out, (h_n, c_n)
