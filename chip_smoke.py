#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py             # from the repo root, on a Hopper card
    python3 chip_smoke.py --profile   # only a torch.profiler loop over the
                                      # darts EF call at batch 64 (PERF.md)

Needs CUDA PyTorch, nvcc for sm_90a and numpy; imports neither JAX nor
the JAX package. Phases, any failure of which makes the script exit
non-zero:

1. Build the CUDA kernels from lctvqa_torch/csrc with nvcc.
2. Each kernel against its plain PyTorch version at full width, with the
   median times of both and of the one PyTorch call that computes the
   same function where there is one. TF32 is off for matmuls and
   convolutions in this phase. Tolerances, as |kernel - plain| <= tol +
   tol * |plain| unless said otherwise:
   - LSTM cell, sequences, decode (E 300, H 512, T 30, V 8192; B = 1, 8,
     64): fp32 h/c 1e-5 (summation order); bf16 h/c 1e-3 (the same plus h
     rounded to bf16 every step, where a 1-ulp fp32 difference can round
     the other way: about 1e-4 at most); tokens equal, except that a
     differing bf16 token must be a near tie: its plain logit within 1e-3
     of the plain maximum. In bf16 the three LSTM kernels also run a
     probe on which rounding h before the recurrent product moves every
     gate by 1.5: the kernel must match the plain version there, and the
     plain version with h left unrounded must not.
   - bn_fwd at the supernet's six shapes, fp32 and bf16 in and out: fp32
     out 1e-5 (summation order); bf16 out |kernel - plain| <= 1e-5 +
     2^-7 |plain|: a 1-ulp fp32 difference can round the normalized value
     to the neighbouring bf16, one bf16 ulp away, which is at most 2^-7
     of the value.
   - mixed_node_fwd at the four cell shapes with E = 1, 3, 5 where the
     cell has them, N = 1, 8, 64: fp32 1e-5 (summation order). In bf16
     every stage output o is rounded to bf16, and a 1-ulp fp32
     difference flips a rounding now and then: one flip moves o by one
     bf16 ulp, at most 2^-7 |o|, and the output by w * 2^-7 * |o| / sigma
     after the folded BatchNorm, where |o| / sigma rarely passes 4; a
     flip in a sep conv's first stage spreads through its second at about
     the same size. The limit is 4 * 2^-7 * max|w| absolute.
3. Full-width W, fixed-EF and darts-EF params (and the supernet's arch
   parameters) from seeded torch.Generators, converted to the JAX
   layout, written as three artifacts with lctvqa_torch.export's
   save_artifact.
4. The artifacts served over HTTP (lctvqa_torch.serve.make_server,
   warmup first) with concurrent /answer, /generate and /healthz, twice
   in fp32: at the default kernel flags, then with the sequence, decode,
   mixed-op node and BatchNorm kernels on. Launch counts are zeroed
   before these runs; each kernel must have launched in the run where
   its flag is on, the node and BatchNorm kernels in the other run not at
   all, and the greedy questions of the two runs must agree for the
   fixed EF.
5. The darts EF at fixed dispatch groups (1, 4 and 64 rows) through
   ServingModel with both flag sets: one forward launches the node kernel
   14 times; the L2-normalized image features of the two within 1e-5
   and the answer logits, which random heads make insensitive to the
   image, within 1e-4 (the same math in another order of sums, through
   four cells of batch-stat BatchNorm);
   greedy tokens equal, or a near tie (the default run's logits of the
   two tokens within 2e-4 at the first differing step).
6. Served outputs on the card against the CPU (plain versions, fp32) on
   a two-image input, at PyTorch's default TF32 settings (the port keeps
   fp32 exact itself): finite, of the expected shapes; logits within
   1e-5 for W and the fixed EF (summation order; TF32 would be off by
   more) and 1e-4 for the darts EF (BatchNorm over a batch of two
   amplifies it), whose image features must agree within 1e-5; tokens
   equal or a near tie as in 5.
7. A batch-64 answer_logits / generate loop: pairs/s (informational).

It prints the card's name and power limit, one JSON line of the kernels
(times, bounds and launch counts), and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import base64
import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

SEED = 0
BATCHES = (1, 8, 64)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 1e-5, "bfloat16": 1e-3}
TIE_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
LOGIT_TOL = 1e-5
DARTS_LOGIT_TOL = 1e-4
DARTS_FEATURE_TOL = 1e-5
DARTS_TIE_TOL = 2e-4
KERNEL_FLAGS = {"default": {},
                "kernels": {"pallas_seq_lstm": True, "pallas_generate": True,
                            "pallas_mixed_op": True}}
# the BatchNorm kernel's switch is process-wide (ops/conv.py), as in the JAX
# package; the "kernels" flag set turns it on for its runs
BN_KERNEL = {"default": False, "kernels": True}
NODE_CALLS_PER_FORWARD = 14
# NVIDIA H100 SXM data sheet: HBM3 bytes/s, dense bf16 tensor FLOP/s, fp32
# FLOP/s outside the tensor cores
H100 = {"bytes": 3.35e12, "bfloat16": 989e12, "float32": 67e12}
# (H, W, C of the cell's states, numbers of stride-1 edges a node has there)
NODE_SHAPES = {"cell0": (64, 64, 16, (3, 5)), "cell1": (32, 32, 32, (1, 3)),
               "cell2": (16, 16, 64, (1, 3)), "cell3": (16, 16, 64, (3, 5))}
# cell preprocess outputs, then the sep convs' inner BN on stride-2 edges
BN_SHAPES = ((64, 64, 64, 16), (64, 64, 64, 32), (64, 32, 32, 64),
             (64, 16, 16, 64), (64, 32, 32, 8), (64, 16, 16, 16))
KERNELS = {  # name -> (source, TPU kernel it replaces, flag that runs it)
    "lstm_cell": ("lctvqa_torch/csrc/lstm.cu",
                  "lctvqa/ops/pallas_lstm.py:42", "default"),
    "lstm_seq_final": ("lctvqa_torch/csrc/lstm.cu",
                       "lctvqa/ops/pallas_lstm.py:172", "kernels"),
    "lstm_seq_all": ("lctvqa_torch/csrc/lstm.cu",
                     "lctvqa/ops/pallas_lstm.py:311", "kernels"),
    "greedy_generate": ("lctvqa_torch/csrc/generate.cu",
                        "lctvqa/ops/pallas_generate.py:142", "kernels"),
    "mixed_node_fwd": ("lctvqa_torch/csrc/mixedop.cu",
                       "lctvqa/ops/pallas_mixedop.py:425", "kernels"),
    "bn_fwd": ("lctvqa_torch/csrc/bn.cu", "lctvqa/ops/pallas_bn.py:81",
               "kernels"),
}
LSTM_KERNELS = ("lstm_cell", "lstm_seq_final", "lstm_seq_all",
                "greedy_generate")
FAILURES: list = []


def log(*args):
    print(*args, flush=True)


def expect(cond: bool, what: str) -> None:
    if not cond:
        FAILURES.append(what)
        log(f"FAIL: {what}")


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times, after warmup."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_library(fn):
    """time_ms of a PyTorch call that serves only as a yardstick; None,
    with the reason logged, where this PyTorch build does not take it."""
    try:
        return time_ms(fn)
    except (RuntimeError, NotImplementedError) as e:
        log(f"library call not timed: {type(e).__name__}: {e}")
        return None


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _max_err(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def _within(got, want, tol: float) -> bool:
    return all(bool(((g - w).abs() <= tol + tol * w.abs()).all())
               for g, w in zip(got, want))


def _plain_logits_at(qst, img_row, prefix, dtype):
    """Plain-version logits of one row's decode step len(prefix), fed the
    tokens `prefix` (the plain decode, teacher-forced)."""
    from lctvqa_torch.models.qst_encoder import START_TOKEN
    from lctvqa_torch.ops import nn as N
    from lctvqa_torch.ops.cuda_lstm import cell_weights, lstm_cell_plain

    w = cell_weights(qst["lstm"]["layers"][0], dtype)
    h = c = img_row[None].float()
    tok = torch.tensor([START_TOKEN], device=img_row.device)
    x = torch.tanh(N.embed(qst["word2vec"], tok))
    for t in range(len(prefix) + 1):
        h, c = lstm_cell_plain(w, x, h, c)
        if t < len(prefix):
            x = N.embed(qst["word2vec"], prefix[t:t + 1])
    return N.linear(qst["fc2"], torch.tanh(h), dtype=dtype)[0]


def _token_gaps(qst, img, got, want, dtype):
    """For each row whose kernel tokens differ from the plain ones: the
    plain logit gap between the plain and the kernel token at the first
    differing step."""
    gaps = []
    for r in torch.nonzero((got != want).any(1)).flatten().tolist():
        t = int(torch.nonzero(got[r] != want[r])[0])
        logits = _plain_logits_at(qst, img[r], want[r, :t].long(), dtype)
        gaps.append(float(logits[want[r, t]] - logits[got[r, t]]))
    return gaps


def _lstm_fns():
    """LSTM kernel -> (wrapper, plain version), both called as
    (weights, xs [B, T, E], h0, c0)."""
    from lctvqa_torch.ops import cuda_lstm as L

    return {
        "lstm_cell": (lambda w, xs, h, c: L.lstm_cell(w, xs[:, 0], h, c),
                      lambda w, xs, h, c: L.lstm_cell_plain(w, xs[:, 0], h,
                                                            c)),
        "lstm_seq_final": (L.lstm_seq_final, L.lstm_seq_final_plain),
        "lstm_seq_all": (L.lstm_seq, L.lstm_seq_plain),
    }


def h_rounding_probe(w, b: int, steps: int):
    """bf16 inputs on which rounding h to bf16 before the recurrent product
    decides the result. x = 0; h0 is 1 - 2^-10 on even units (rounds to
    1) and -(0.5 + 2^-10) on odd units (rounds to -0.5); W_hh rows are 2s
    on even units and 4s on odd ones, s = 512 // H. Every gate's
    recurrent sum is then exactly 0 with h rounded and -3sH/1024 (-1.5 at
    H = 512) without. -> (probe weights, the same in fp32 so that h is
    not rounded, inputs (xs, h0, c0))."""
    from lctvqa_torch.ops.cuda_lstm import CellWeights

    hid, emb = w.w_hh.shape[0], w.w_ih.shape[0]
    dev = w.w_hh.device
    even = torch.arange(hid, device=dev) % 2 == 0
    h0 = torch.where(even, 1 - 2 ** -10, -(0.5 + 2 ** -10)).float()
    s = max(1, 512 // hid)
    w_hh = torch.where(even, 2.0 * s, 4.0 * s)[:, None].expand(hid, 4 * hid)
    probe = CellWeights(w.w_ih, w_hh.to(w.w_hh.dtype).contiguous(), w.b)
    unrounded = CellWeights(w.w_ih.float(), w_hh.float().contiguous(), w.b)
    h0 = h0.expand(b, hid).contiguous()
    xs = torch.zeros(b, steps, emb, device=dev)
    return probe, unrounded, (xs, h0, torch.zeros_like(h0))


def bound(n_bytes: float, flops: float, dname: str):
    """The least time in ms the card could take: the larger of the bytes
    over its memory rate and the operations over its peak rate for their
    type -> (ms, "bytes" or "operations")."""
    by_bytes, by_ops = n_bytes / H100["bytes"], flops / H100[dname]
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                         else "operations")


def lstm_bounds(mcfg, b: int, dname: str):
    """Bounds of the four LSTM-family kernels: each input read once (the
    weights once for the whole batch and all steps), each output written
    once; the products at the tensor-core rate of their operand type."""
    e, h, t, v = (mcfg.word_embed_size, mcfg.lstm_hidden_size,
                  mcfg.max_qst_len, mcfg.qst_vocab_size)
    wb = 2 if dname == "bfloat16" else 4
    weights = (e + h) * 4 * h * wb + 4 * h * 4
    state = 2 * b * h * 4
    cell_flops = 2 * b * (e + h) * 4 * h
    head = h * v * wb + v * 4
    return {
        "lstm_cell": bound(weights + b * e * wb + 2 * state, cell_flops,
                           dname),
        "lstm_seq_final": bound(weights + b * t * e * wb + state,
                                t * cell_flops, dname),
        "lstm_seq_all": bound(weights + b * t * e * wb + 2 * state
                              + b * t * h * 4, t * cell_flops, dname),
        # the decode gathers one fp32 embedding row per token
        "greedy_generate": bound(weights + head + b * h * 4 + b * t * e * 4
                                 + b * t * 4,
                                 t * (cell_flops + 2 * b * h * v), dname),
    }


def lstm_library_fns(w, xs, h0, device):
    """The one PyTorch call per LSTM kernel that computes the same function
    on the same inputs, for timing only: nn.LSTMCell for the cell, nn.LSTM
    (cuDNN) over all steps for the sequences. Nothing decodes greedily in
    one call."""
    emb, hid = w.w_ih.shape[0], w.w_hh.shape[0]
    dt = w.w_ih.dtype
    cell = torch.nn.LSTMCell(emb, hid, device=device, dtype=dt)
    seq = torch.nn.LSTM(emb, hid, batch_first=True, device=device, dtype=dt)
    with torch.no_grad():
        for mod, sfx in ((cell, ""), (seq, "_l0")):
            getattr(mod, "weight_ih" + sfx).copy_(w.w_ih.t())
            getattr(mod, "weight_hh" + sfx).copy_(w.w_hh.t())
            getattr(mod, "bias_ih" + sfx).copy_(w.b)
            getattr(mod, "bias_hh" + sfx).zero_()
    seq.flatten_parameters()
    x, h = xs.to(dt), h0.to(dt)
    state = (h[None].contiguous(), h[None].contiguous())

    @torch.no_grad()
    def run_cell():
        return cell(x[:, 0], (h, h))

    @torch.no_grad()
    def run_seq():
        return seq(x, state)

    return {"lstm_cell": run_cell, "lstm_seq_final": run_seq,
            "lstm_seq_all": run_seq}


def check_kernels(device, mcfg, batches=BATCHES, time_fn=time_ms):
    """-> {kernel: {(B, dtype): {"err", "ms", "plain_ms", "library_ms",
    "bound_ms", "bound_by"[, "probe_err", "control_err"]}}}."""
    from lctvqa_torch.models.qst_encoder import ef_qst_encoder_init
    from lctvqa_torch.ops import cuda_generate, cuda_lstm
    from lctvqa_torch.ops import nn as N

    gen = torch.Generator().manual_seed(SEED)
    qst = ef_qst_encoder_init(gen, mcfg.qst_vocab_size, mcfg.word_embed_size,
                              mcfg.img_embed_size, 1, mcfg.lstm_hidden_size)
    qst = _to(qst, device)
    seq, hid = mcfg.max_qst_len, mcfg.lstm_hidden_size
    results = {name: {} for name in LSTM_KERNELS}
    for b in batches:
        ids = torch.randint(0, mcfg.qst_vocab_size, (b, seq), generator=gen)
        xs = torch.tanh(N.embed(qst["word2vec"], ids.to(device)))
        h0 = N.l2_normalize(torch.randn(b, hid, generator=gen)).to(device)
        # the inputs the serving path gives each kernel: the W encoder
        # starts from zeros, the EF encoder and the cell from the image
        inputs = {"lstm_cell": (xs, h0, h0), "lstm_seq_final": (xs, None, None),
                  "lstm_seq_all": (xs, h0, h0)}
        for dname, dtype in DTYPES.items():
            w = cuda_lstm.cell_weights(qst["lstm"]["layers"][0], dtype)
            bounds = lstm_bounds(mcfg, b, dname)
            library = lstm_library_fns(w, xs, h0, device)
            for name, (kern, plain) in _lstm_fns().items():
                args = (w,) + inputs[name]
                got, want = _leaves(kern(*args)), _leaves(plain(*args))
                err = _max_err(got, want)
                expect(_within(got, want, TOL[dname]),
                       f"{name} B={b} {dname}: max |kernel - plain| = {err}"
                       f" exceeds {TOL[dname]}")
                r = results[name][(b, dname)] = {
                    "err": err, "ms": time_fn(lambda: kern(*args)),
                    "plain_ms": time_fn(lambda: plain(*args)),
                    "library_ms": time_library(library[name]),
                    "bound_ms": bounds[name][0], "bound_by": bounds[name][1]}
                if dname != "bfloat16":
                    continue
                probe, unrounded, p_in = h_rounding_probe(w, b, seq)
                p_want = _leaves(plain(probe, *p_in))
                p_got = _leaves(kern(probe, *p_in))
                control = _leaves(plain(unrounded, *p_in))
                r["probe_err"] = _max_err(p_got, p_want)
                r["control_err"] = _max_err(control, p_want)
                expect(_within(p_got, p_want, TOL[dname]),
                       f"{name} B={b} h-rounding probe: max |kernel - "
                       f"plain| = {r['probe_err']} exceeds {TOL[dname]}")
                expect(not _within(control, p_want, TOL[dname]),
                       f"{name} B={b} h-rounding probe: unrounded h is "
                       f"within {TOL[dname]} of the plain version")
            got = cuda_generate.greedy_generate(qst, h0, seq, dtype)
            want = cuda_generate.greedy_generate_plain(qst, h0, seq, dtype)
            expect(got.shape == (b, seq) and got.dtype == torch.int32,
                   f"greedy_generate B={b} {dname}: shape/dtype")
            gaps = _token_gaps(qst, h0, got, want, dtype)
            for gap in gaps:
                log(f"greedy_generate B={b} {dname}: a token differs at a "
                    f"plain logit gap of {gap}")
            expect(all(g <= TIE_TOL[dname] for g in gaps) and (
                dname == "bfloat16" or not gaps),
                f"greedy_generate B={b} {dname}: tokens differ, gaps {gaps}")
            results["greedy_generate"][(b, dname)] = {
                "err": max(gaps, default=0.0),
                "ms": time_fn(lambda: cuda_generate.greedy_generate(
                    qst, h0, seq, dtype)),
                "plain_ms": time_fn(lambda: cuda_generate.greedy_generate_plain(
                    qst, h0, seq, dtype)),
                "library_ms": None,
                "bound_ms": bounds["greedy_generate"][0],
                "bound_by": bounds["greedy_generate"][1]}
    for name, per in results.items():
        for (b, dname), r in sorted(per.items()):
            probe = (f"  h-rounding probe {r['probe_err']:.3e}, unrounded "
                     f"control {r['control_err']:.3e}"
                     if "probe_err" in r else "")
            log(f"kernel {name:16s} B={b:3d} {dname:9s} {_times(r)}{probe}")
    return results


def _times(r) -> str:
    lib = ("none" if r["library_ms"] is None
           else f"{r['library_ms']:.4f} ms")
    return (f"max_abs_err {r['err']:.3e}  kernel {r['ms']:.4f} ms  plain "
            f"{r['plain_ms']:.4f} ms  library {lib}  bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']})")


def check_bn_kernel(device, time_fn=time_ms):
    """bn_fwd at the supernet's shapes -> {(shape, in, out): {...}}."""
    import torch.nn.functional as F

    from lctvqa_torch.ops import cuda_bn

    gen = torch.Generator().manual_seed(SEED + 10)
    results = {}
    for shape in BN_SHAPES:
        base = (1.5 * torch.randn(shape, generator=gen) + 0.3).to(device)
        for in_name, in_dt in DTYPES.items():
            x = base.to(in_dt)
            nchw = x.permute(0, 3, 1, 2)  # a channels-last view, no copy
            for out_name, out_dt in DTYPES.items():
                got = cuda_bn.batchnorm_fwd(x, out_dtype=out_dt)
                want = cuda_bn.batchnorm_plain(x, out_dtype=out_dt)
                torch.cuda.synchronize()
                diff = (got.float() - want.float()).abs()
                limit = (1e-5 + 1e-5 * want.float().abs()
                         if out_name == "float32"
                         else 1e-5 + 2.0 ** -7 * want.float().abs())
                err = float(diff.max())
                tag = f"bn_fwd {shape} {in_name}->{out_name}"
                expect(got.dtype == out_dt and got.shape == x.shape
                       and bool((diff <= limit).all()),
                       f"{tag}: max |kernel - plain| = {err} exceeds its "
                       "limit")
                n = x.numel()
                ms, by = bound(n * (x.element_size() + got.element_size()),
                               5 * n, "float32")
                r = results[(shape, in_name, out_name)] = {
                    "err": err, "bound_ms": ms, "bound_by": by,
                    "ms": time_fn(lambda: cuda_bn.batchnorm_fwd(
                        x, out_dtype=out_dt)),
                    "plain_ms": time_fn(lambda: cuda_bn.batchnorm_plain(
                        x, out_dtype=out_dt)),
                    "library_ms": time_library(lambda: F.batch_norm(
                        nchw, None, None, training=True, eps=1e-5))}
                log(f"kernel {tag}: {_times(r)}")
    return results


def node_bound(n, h, w, cs, edges, dname):
    """Each edge's Cs-channel slice read once, the fp32 output written
    once; per input element 102 depthwise taps, six Cs-wide pointwise
    sums, two 9-tap pools and the statistics and fold of seven stage
    outputs, all fp32 outside the tensor cores."""
    elems = n * h * w * cs
    wb = 2 if dname == "bfloat16" else 4
    flops = edges * elems * (2 * 102 + 2 * 6 * cs + 18 + 7 * 5)
    return bound(edges * elems * wb + elems * 4, flops, "float32")


def check_node_kernel(device, batches=BATCHES, time_fn=time_ms):
    """mixed_node_fwd at the four cell shapes ->
    {(cell, E, N, dtype): {...}}."""
    from lctvqa_torch.models import search
    from lctvqa_torch.ops import cuda_mixedop

    gen = torch.Generator().manual_seed(SEED + 11)
    results = {}
    for cell, (h, w, c, edge_counts) in NODE_SHAPES.items():
        cs = c // 4
        ops = [_to(search.mixed_op_init(gen, c, 1, 4), device)
               for _ in range(max(edge_counts))]
        ops = [dict(p, node=cuda_mixedop.node_weights(p)) for p in ops]
        for n in batches:
            states = [torch.randn(n, h, w, c, generator=gen).to(device)
                      for _ in ops]
            for edges in edge_counts:
                wts = (torch.softmax(torch.randn(edges, 8, generator=gen), 1)
                       * torch.softmax(torch.randn(edges, generator=gen),
                                       0)[:, None]).to(device)
                nodes = [p["node"] for p in ops[:edges]]
                for dname, dtype in DTYPES.items():
                    xs = [s.to(dtype) for s in states[:edges]]
                    got = cuda_mixedop.mixed_node(xs, ops[:edges], wts, cs)
                    want = cuda_mixedop.mixed_node_plain(xs, nodes, wts, cs)
                    torch.cuda.synchronize()
                    diff = (got - want).abs()
                    limit = (1e-5 + 1e-5 * want.abs() if dname == "float32"
                             else 4 * 2.0 ** -7 * float(wts.max())
                             + 0 * want)
                    err = float(diff.max())
                    tag = (f"mixed_node_fwd {cell} {h}x{w} Cs={cs} E={edges} "
                           f"N={n} {dname}")
                    expect(got.shape == (n, h, w, cs)
                           and got.dtype == torch.float32
                           and bool(torch.isfinite(got).all())
                           and bool((diff <= limit).all()),
                           f"{tag}: max |kernel - plain| = {err} exceeds "
                           f"{float(limit.max())}")
                    ms, by = node_bound(n, h, w, cs, edges, dname)
                    r = results[(cell, edges, n, dname)] = {
                        "err": err, "bound_ms": ms, "bound_by": by,
                        "library_ms": None,
                        "ms": time_fn(lambda: cuda_mixedop.mixed_node(
                            xs, ops[:edges], wts, cs)),
                        "plain_ms": time_fn(
                            lambda: cuda_mixedop.mixed_node_plain(
                                xs, nodes, wts, cs), reps=5, warmup=1)}
                    log(f"kernel {tag}: {_times(r)}")
    return results


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


# ---------------------------------------------------------------------------
# phase 3: artifacts
# ---------------------------------------------------------------------------

def vocab_words(mcfg):
    qst = (["<pad>", "<unk>", "<start>", "<end>"]
           + [f"w{i}" for i in range(mcfg.qst_vocab_size - 4)])
    ans = ["<unk>"] + [f"a{i}" for i in range(mcfg.ans_vocab_size - 1)]
    return qst, ans


def model_configs():
    """Full width: ModelConfig's defaults, whose encoder is the PC-DARTS
    supernet, and the same with the fixed VGG19 encoder."""
    import dataclasses

    from lctvqa_torch.config import ModelConfig

    darts = ModelConfig()
    fixed = dataclasses.replace(darts, arch_type="fixed")
    return {"w": fixed, "ef": fixed, "darts": darts}


def write_artifacts(out_dir: Path, names=("w", "ef", "darts")):
    """Seeded full-width W, fixed-EF and darts-EF params -> artifact files.
    The supernet's arch parameters are scaled up from their 1e-3 init so
    that the op mixture is not uniform."""
    from lctvqa_torch import __version__, convert
    from lctvqa_torch.export import ARTIFACT_VERSION, save_artifact
    from lctvqa_torch.models import vqa_ef, vqa_w

    paths = {}
    for seed, name in enumerate(names, start=SEED + 1):
        mcfg = model_configs()[name]
        qst_words, ans_words = vocab_words(mcfg)
        gen = torch.Generator().manual_seed(seed)
        if name == "w":
            params, arch = vqa_w.init_w_model(gen, mcfg), None
        else:
            params, arch = vqa_ef.init_ef_model(gen, mcfg)
        bundle = {"params": convert.to_jax(params)}
        if arch is not None:
            bundle["arch"] = convert.to_jax(
                {k: 500.0 * v for k, v in arch.items()})
        n = sum(p.numel() for p in _leaves(params))
        meta = {"artifact_version": ARTIFACT_VERSION,
                "family": "w" if name == "w" else "ef",
                "int8": False, "platforms": ["cuda"],
                "img_size": mcfg.img_size, "max_qst_len": mcfg.max_qst_len,
                "qst_vocab_size": mcfg.qst_vocab_size,
                "ans_vocab_size": mcfg.ans_vocab_size,
                "arch_type": mcfg.arch_type, "epoch": None,
                "lctvqa_version": __version__, "qst_words": qst_words,
                "ans_words": ans_words}
        path = out_dir / f"{name}.lctx"
        save_artifact({"exported": {}, "params": bundle, "meta": meta},
                      str(path))
        log(f"artifact {name}: {n} params, "
            f"{path.stat().st_size / 2**20:.1f} MiB")
        paths[name] = str(path)
    return paths


class kernel_flags:
    """The flag set `fname` for a run: ModelConfig overrides as `.flags`,
    and the process-wide BatchNorm kernel switch set for the duration."""

    def __init__(self, fname: str):
        self.fname = fname
        self.flags = KERNEL_FLAGS[fname]

    def __enter__(self):
        from lctvqa_torch.ops import conv

        self._was = conv.USE_PALLAS_BN
        conv.USE_PALLAS_BN = BN_KERNEL[self.fname]
        return self.flags

    def __exit__(self, *exc):
        from lctvqa_torch.ops import conv

        conv.USE_PALLAS_BN = self._was


# ---------------------------------------------------------------------------
# phase 4: HTTP serving
# ---------------------------------------------------------------------------

# the servers are local: no proxy from the environment may carry a request
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _post(port: int, path: str, payload=None):
    url = f"http://127.0.0.1:{port}{path}"
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with _OPENER.open(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def serve_run(paths, device, flags, n_answer=48, n_generate=24,
              max_batch=64):
    """Serve the artifacts, send concurrent requests; -> responses."""
    from lctvqa_torch import serve

    mcfg = model_configs()["w"]
    qst_words, ans_words = vocab_words(mcfg)
    rng = np.random.default_rng(SEED)
    s = mcfg.img_size
    images = rng.integers(0, 256, (max(n_answer, n_generate), s, s, 3),
                          dtype=np.uint8)
    questions = [" ".join(rng.choice(qst_words[4:], 6)) for _ in images]
    servers = {}
    try:
        for name, path in paths.items():
            t0 = time.perf_counter()
            srv = serve.make_server(path, port=0, window_ms=5.0,
                                    max_batch=max_batch, device=device,
                                    compute_dtype="float32", **flags)
            calls = srv.RequestHandlerClass.service.warmup()
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            servers[name] = srv
            log(f"serve {name}: loaded and warmed {calls} calls in "
                f"{time.perf_counter() - t0:.1f} s")
        ports = {f: srv.server_address[1] for f, srv in servers.items()}

        def img_b64(i):
            return base64.b64encode(images[i].tobytes()).decode()

        jobs = [(name, "/answer", i) for name in paths
                for i in range(n_answer)]
        jobs += [(name, "/generate", i) for name in paths if name != "w"
                 for i in range(n_generate)]

        def ask(job):
            name, path, i = job
            payload = {"image_b64": img_b64(i)}
            if path == "/answer":
                payload["question"] = questions[i]
            return _post(ports[name], path, payload)

        t0 = time.perf_counter()
        with ThreadPoolExecutor(32) as pool:
            results = list(pool.map(ask, jobs))
        wall = time.perf_counter() - t0
        health = {f: _post(p, "/healthz") for f, p in ports.items()}
        groups = {name: srv.RequestHandlerClass.service.batcher.batch_sizes
                  for name, srv in servers.items()}
    finally:
        for srv in servers.values():
            srv.shutdown()
            srv.server_close()
    out = {f"{name}_{path[1:]}": [] for name, path, _ in jobs}
    for (name, path, _), (status, body) in zip(jobs, results):
        expect(status == 200, f"{name} {path}: HTTP {status} {body}")
        out[f"{name}_{path[1:]}"].append(body)
        ok = (isinstance(body.get("answer_id"), int)
              and 0 <= body["answer_id"] < mcfg.ans_vocab_size
              and body.get("answer") == ans_words[body["answer_id"]])
        if path == "/generate":
            ok = ok and isinstance(body.get("question"), str)
        expect(ok, f"{name} {path}: malformed response {body}")
    for name, (status, body) in health.items():
        expect(status == 200 and body.get("ok") is True
               and body.get("family") == ("w" if name == "w" else "ef"),
               f"{name} /healthz: {status} {body}")
    log(f"served {len(jobs)} requests in {wall:.2f} s "
        f"({len(jobs) / wall:.1f} req/s, 32 client threads); dispatch "
        f"groups: " + ", ".join(f"{k} {len(v)} (largest {max(v)})"
                                for k, v in groups.items()))
    return out


# ---------------------------------------------------------------------------
# phase 5: the darts EF at fixed dispatch groups, both flag sets
# ---------------------------------------------------------------------------

def _image_features(model, u8) -> torch.Tensor:
    """The EF model's L2-normalized image embedding [B, embed]."""
    from lctvqa_torch.data.pipeline import normalize_images
    from lctvqa_torch.models import vqa_ef

    with torch.inference_mode():
        img = normalize_images(torch.as_tensor(u8).to(model.device))
        return vqa_ef.ef_img_encode(model.params, model.arch, model.config,
                                    img)


def _features_agree(got, want, tag) -> None:
    got, want = got.cpu(), want.cpu()
    err = float((got - want).abs().max())
    log(f"{tag}: image features max |diff| {err:.3e} (scale "
        f"{float(want.abs().max()):.3f})")
    expect(bool(torch.isfinite(got).all())
           and _within([got], [want], DARTS_FEATURE_TOL),
           f"{tag}: image features differ by {err}")


def _tokens_agree(model, u8, got_tok, want_tok, tag) -> None:
    """Greedy tokens equal, or a near tie: at the first differing step the
    logits `model` gives the two tokens, fed the common prefix, lie within
    DARTS_TIE_TOL of each other."""
    if torch.equal(got_tok, want_tok):
        return
    with torch.inference_mode():
        feat = _image_features(model, u8)
        gaps = _token_gaps(model.params["qst"], feat, got_tok.to(feat.device),
                           want_tok.to(feat.device), torch.float32)
    for gap in gaps:
        log(f"{tag}: a token differs at a logit gap of {gap}")
    expect(all(abs(g) <= DARTS_TIE_TOL for g in gaps),
           f"{tag}: greedy tokens differ beyond a near tie, gaps {gaps}")


def check_darts_groups(path, device, groups=(1, 4, 64)):
    from lctvqa_torch.export import ServingModel, read_artifact
    from lctvqa_torch.ops import _build

    art = read_artifact(path)
    mcfg = model_configs()["darts"]
    rng = np.random.default_rng(SEED + 5)
    s = mcfg.img_size
    models = {}
    for fname in KERNEL_FLAGS:
        with kernel_flags(fname) as flags:
            models[fname] = ServingModel(art, device, compute_dtype="float32",
                                         **flags)
    for n in groups:
        u8 = rng.integers(0, 256, (n, s, s, 3), dtype=np.uint8)
        qst = rng.integers(0, mcfg.qst_vocab_size, (n, mcfg.max_qst_len),
                           dtype=np.int32)
        out = {}
        for fname, model in models.items():
            with kernel_flags(fname):
                before = _build.launch_counts()
                logits = model.answer_logits(u8, qst)
                after = _build.launch_counts()
                tok, ans = model.generate(u8)
                feat = _image_features(model, u8)
            torch.cuda.synchronize()
            out[fname] = (logits, tok, ans, feat)
            calls = {k: after[k] - before[k]
                     for k in ("mixed_node_fwd", "bn_fwd")}
            log(f"darts group of {n}, {fname}: one answer_logits call "
                f"launched {calls}")
            want = ({"mixed_node_fwd": NODE_CALLS_PER_FORWARD}
                    if fname == "kernels"
                    else {"mixed_node_fwd": 0, "bn_fwd": 0})
            expect(all(calls[k] == v for k, v in want.items())
                   and (fname == "default" or calls["bn_fwd"] > 0),
                   f"darts group of {n}, {fname}: launches {calls}, "
                   f"expected {want}")
        _features_agree(out["kernels"][3], out["default"][3],
                        f"darts group of {n}, kernels vs default")
        a, b = out["default"][0], out["kernels"][0]
        err = float((a - b).abs().max())
        expect(bool(torch.isfinite(b).all()) and _within(
            [b], [a], DARTS_LOGIT_TOL),
            f"darts group of {n}: answer logits of the two flag sets "
            f"differ by {err}")
        log(f"darts group of {n}: answer logits default vs kernels max "
            f"|diff| {err:.3e} (scale {float(a.abs().max()):.3f})")
        _tokens_agree(models["default"], u8, out["kernels"][1],
                      out["default"][1], f"darts group of {n}")
    del models
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 6 and 7: reference check and throughput
# ---------------------------------------------------------------------------

def check_against_cpu(paths, device):
    from lctvqa_torch.export import ServingModel, read_artifact

    rng = np.random.default_rng(SEED + 3)
    for name, path in paths.items():
        mcfg = model_configs()[name]
        s = mcfg.img_size
        u8 = rng.integers(0, 256, (2, s, s, 3), dtype=np.uint8)
        qst = rng.integers(0, mcfg.qst_vocab_size, (2, mcfg.max_qst_len),
                           dtype=np.int32)
        tol = DARTS_LOGIT_TOL if name == "darts" else LOGIT_TOL
        art = read_artifact(path)
        ref = ServingModel(art, "cpu", compute_dtype="float32")
        want = ref.answer_logits(u8, qst)
        want_gen = ref.generate(u8) if name != "w" else None
        for fname in KERNEL_FLAGS:
            with kernel_flags(fname) as flags:
                model = ServingModel(art, device, compute_dtype="float32",
                                     **flags)
                got = model.answer_logits(u8, qst).cpu()
                err = float((got - want).abs().max())
                expect(got.shape == (2, mcfg.ans_vocab_size)
                       and bool(torch.isfinite(got).all())
                       and _within([got], [want], tol),
                       f"{name} {fname}: answer logits vs CPU max err {err}")
                log(f"{name} {fname}: answer logits vs CPU max |err| "
                    f"{err:.3e}")
                if want_gen is not None:
                    tok, ans = (t.cpu() for t in model.generate(u8))
                    expect(tok.shape == (2, mcfg.max_qst_len)
                           and tok.dtype == torch.int32,
                           f"{name} {fname}: generate shape/dtype")
                    if name == "darts":
                        _features_agree(_image_features(model, u8),
                                        _image_features(ref, u8),
                                        f"{name} {fname} vs CPU")
                        _tokens_agree(ref, u8, tok, want_gen[0],
                                      f"{name} {fname} vs CPU")
                    else:
                        expect(torch.equal(tok, want_gen[0])
                               and torch.equal(ans, want_gen[1]),
                               f"{name} {fname}: generate differs from the "
                               "CPU")
            del model
        del ref, art
    torch.cuda.empty_cache()


def throughput(paths, device, batch=64, iters=10):
    from lctvqa_torch.export import ServingModel, read_artifact

    rows = []
    for name, path in paths.items():
        art = read_artifact(path)
        s, seq = art["meta"]["img_size"], art["meta"]["max_qst_len"]
        rng = np.random.default_rng(SEED + 4)
        u8 = torch.from_numpy(rng.integers(0, 256, (batch, s, s, 3),
                                           dtype=np.uint8))
        qst = torch.zeros(batch, seq, dtype=torch.int32)
        for dtype in (("bfloat16",) if name == "darts"
                      else ("bfloat16", "float32")):
            for fname in KERNEL_FLAGS:
                with kernel_flags(fname) as flags:
                    model = ServingModel(art, device, compute_dtype=dtype,
                                         **flags)
                    fns = {"answer_logits":
                           lambda: model.answer_logits(u8, qst)}
                    if name != "w":
                        fns["generate"] = lambda: model.generate(u8)
                    for fn_name, fn in fns.items():
                        for _ in range(2):
                            fn()
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        for _ in range(iters):
                            fn()
                        torch.cuda.synchronize()
                        dt = time.perf_counter() - t0
                        rows.append((name, fn_name, dtype, fname,
                                     batch * iters / dt, 1e3 * dt / iters))
                del model
        del art
    torch.cuda.empty_cache()
    return rows


def profile_darts(path, device, batch=64, iters=5):
    """A torch.profiler loop over the darts EF's answer_logits at batch 64
    in bf16, both flag sets: device time by kernel name and the device's
    busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lctvqa_torch.export import ServingModel, read_artifact

    art = read_artifact(path)
    s, seq = art["meta"]["img_size"], art["meta"]["max_qst_len"]
    rng = np.random.default_rng(SEED + 4)
    u8 = torch.from_numpy(rng.integers(0, 256, (batch, s, s, 3),
                                       dtype=np.uint8))
    qst = torch.zeros(batch, seq, dtype=torch.int32)
    for fname in KERNEL_FLAGS:
        with kernel_flags(fname) as flags:
            model = ServingModel(art, device, compute_dtype="bfloat16",
                                 **flags)
            for _ in range(3):
                model.answer_logits(u8, qst)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    model.answer_logits(u8, qst)
                torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / iters
        # device kernels are the rows whose own device type is CUDA; an op
        # row's device time repeats that of the kernels it launched
        def dev_us(e):
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0))

        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
        expect(bool(events), f"profile {fname}: the profiler saw no device "
               "kernel")
        total_ms = sum(dev_us(e) for e in events) / 1e3 / iters
        log(f"profile darts answer_logits B={batch} bf16 {fname}: wall "
            f"{wall_ms:.3f} ms/call under the profiler, device "
            f"{total_ms:.3f} ms/call, {sum(e.count for e in events) // iters}"
            f" device kernels/call")
        for e in sorted(events, key=dev_us, reverse=True)[:16]:
            log(f"  {dev_us(e) / 1e3 / iters:8.3f} ms/call  "
                f"{e.count // iters:5d} launches/call  {e.key[:90]}")
        del model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------

def kernel_rows(lstm, bn, node, launches):
    """The kernels line: one row per kernel at the largest shape the
    batch-64 bf16 serving path gives it."""
    picks = {name: (lstm[name][(64, "bfloat16")], "B=64 bfloat16")
             for name in LSTM_KERNELS}
    picks["mixed_node_fwd"] = (node[("cell0", 5, 64, "bfloat16")],
                               "cell0 64x64 Cs=4 E=5 N=64 bfloat16")
    picks["bn_fwd"] = (bn[((64, 64, 64, 32), "float32", "bfloat16")],
                       "[64,64,64,32] float32 -> bfloat16")
    rows = []
    for name, (source, replaces, _) in KERNELS.items():
        r, shape = picks[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": r["err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "shape": shape})
        if name in LSTM_KERNELS:
            rows[-1]["fp32_max_abs_err"] = max(
                lstm[name][(b, "float32")]["err"] for b in BATCHES)
        if "probe_err" in r:
            rows[-1]["h_rounding_probe_err"] = max(
                lstm[name][(b, "bfloat16")]["probe_err"] for b in BATCHES)
    return rows


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="only build, then profile the darts EF call")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on an NVIDIA GPU", file=sys.stderr)
        return 1
    from lctvqa_torch.ops import _build

    device = torch.device("cuda")
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # 1. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"built {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for line in (_build.BUILD_DIR / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log("ptxas:", line.strip())

    if args.profile:
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
            paths = write_artifacts(Path(tmp), names=("darts",))
            profile_darts(paths["darts"], device)
        log(card)
        return 1 if FAILURES else 0

    # 2. kernels vs plain versions, TF32 off; later phases run at
    # PyTorch's defaults, as a server does
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    kern = check_kernels(device, model_configs()["w"])
    kern_bn = check_bn_kernel(device)
    kern_node = check_node_kernel(device)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    log(f"kernel phase took {time.perf_counter() - t0:.1f} s; TF32 at "
        f"PyTorch's defaults from here: matmul {tf32[0]}, cuDNN {tf32[1]}")
    log(card)

    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
        # 3. artifacts
        paths = write_artifacts(Path(tmp))

        # 4. the main path: HTTP serving, twice
        _build.reset_launch_counts()
        responses, per_run = {}, {}
        for fname in KERNEL_FLAGS:
            before = _build.launch_counts()
            with kernel_flags(fname) as flags:
                responses[fname] = serve_run(paths, device, flags)
            after = _build.launch_counts()
            per_run[fname] = {k: after[k] - before[k] for k in after}
            log(f"launches in the {fname} run: {per_run[fname]}")
        launches = _build.launch_counts()
        for name, (_, _, run) in KERNELS.items():
            expect(per_run[run][name] > 0,
                   f"{name} never launched in the {run} serving run")
        for name in ("mixed_node_fwd", "bn_fwd"):
            expect(per_run["default"][name] == 0,
                   f"{name} launched in the default serving run")
        gen_a = responses["default"]["ef_generate"]
        gen_b = responses["kernels"]["ef_generate"]
        expect(gen_a == gen_b, "greedy questions differ between the default "
               "and the kernels run")
        same = sum(a == b for a, b in zip(responses["default"]["w_answer"],
                                          responses["kernels"]["w_answer"]))
        log(f"generate responses equal across runs: {gen_a == gen_b}; W "
            f"answers equal: {same}/{len(responses['default']['w_answer'])}")

        # 5. the darts EF at fixed groups, both flag sets
        check_darts_groups(paths["darts"], device)

        # 6. against the CPU
        check_against_cpu(paths, device)

        # 7. throughput (informational)
        for name, fn_name, dtype, fname, rate, ms in throughput(paths,
                                                                device):
            log(f"throughput {name} {fn_name} B=64 {dtype} {fname}: "
                f"{rate:.1f} pairs/s ({ms:.2f} ms/batch) on {card}")

    rows = kernel_rows(kern, kern_bn, kern_node, launches)
    if FAILURES:
        log(f"{len(FAILURES)} check(s) failed:")
        for f in FAILURES:
            log(f"  {f}")
        return 1
    log(json.dumps({"kernels": rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
