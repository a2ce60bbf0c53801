#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repo root, on a Hopper card

Needs CUDA PyTorch, nvcc for sm_90a and numpy; imports no JAX. Phases,
any failure of which makes the script exit non-zero:

1. Build the CUDA kernels from lctvqa_torch/csrc with nvcc.
2. Each kernel against its plain PyTorch version at full width (E 300,
   H 512, T 30, V 8192) for B = 1, 8, 64 in fp32 and bf16, with both
   median times. TF32 is off for matmuls and convolutions in this phase.
   Tolerances, each as |kernel - plain| <= tol + tol * |plain|: fp32 h/c
   1e-5 (summation order); bf16 h/c 1e-3 (the same plus h rounded to
   bf16 every step, where a 1-ulp fp32 difference can round the other
   way: about 1e-4 at most); tokens equal, except that a differing bf16
   token must be a near tie: its plain logit within 1e-3 of the plain
   maximum. In bf16 the three LSTM kernels also run a probe on which
   rounding h before the recurrent product moves every gate by 1.5: the
   kernel must match the plain version there, and the plain version
   with h left unrounded must not.
3. Full-width W and fixed-EF params from seeded torch.Generators,
   converted to the JAX layout, written as two artifacts with
   lctvqa.export.save_artifact.
4. Both artifacts served over HTTP (lctvqa_torch.serve.make_server,
   warmup first) with concurrent /answer, /generate and /healthz, twice in
   fp32: at the default kernel flags, then with the sequence and decode
   kernels on. Launch counts are zeroed before these runs; each kernel
   must have launched in the run where its flag is on, and the greedy
   questions of the two runs must agree.
5. Served outputs on the card against the CPU (plain versions, fp32) on
   a two-image input, at PyTorch's default TF32 settings (the port keeps
   fp32 exact itself): finite, of the expected shapes, logits within
   1e-5 (summation order; TF32 would be off by more), tokens equal.
6. A batch-64 answer_logits / generate loop: pairs/s (informational).

It prints the card's name and power limit, one JSON line of the kernels,
and last {"ok": true, "device": {...}}.
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
KERNEL_FLAGS = {"default": {},
                "kernels": {"pallas_seq_lstm": True, "pallas_generate": True}}
KERNELS = {  # name -> (source, TPU kernel it replaces, flag that runs it)
    "lstm_cell": ("lctvqa_torch/csrc/lstm.cu",
                  "lctvqa/ops/pallas_lstm.py:42", "default"),
    "lstm_seq_final": ("lctvqa_torch/csrc/lstm.cu",
                       "lctvqa/ops/pallas_lstm.py:172", "kernels"),
    "lstm_seq_all": ("lctvqa_torch/csrc/lstm.cu",
                     "lctvqa/ops/pallas_lstm.py:311", "kernels"),
    "greedy_generate": ("lctvqa_torch/csrc/generate.cu",
                        "lctvqa/ops/pallas_generate.py:142", "kernels"),
}
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


def check_kernels(device, mcfg, batches=BATCHES, time_fn=time_ms):
    """-> {kernel: {(B, dtype): {"err", "ms", "plain_ms"[, "probe_err",
    "control_err"]}}}."""
    from lctvqa_torch.models.qst_encoder import ef_qst_encoder_init
    from lctvqa_torch.ops import cuda_generate, cuda_lstm
    from lctvqa_torch.ops import nn as N

    gen = torch.Generator().manual_seed(SEED)
    qst = ef_qst_encoder_init(gen, mcfg.qst_vocab_size, mcfg.word_embed_size,
                              mcfg.img_embed_size, 1, mcfg.lstm_hidden_size)
    qst = _to(qst, device)
    seq, hid = mcfg.max_qst_len, mcfg.lstm_hidden_size
    results = {name: {} for name in KERNELS}
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
            for name, (kern, plain) in _lstm_fns().items():
                args = (w,) + inputs[name]
                got, want = _leaves(kern(*args)), _leaves(plain(*args))
                err = _max_err(got, want)
                expect(_within(got, want, TOL[dname]),
                       f"{name} B={b} {dname}: max |kernel - plain| = {err}"
                       f" exceeds {TOL[dname]}")
                r = results[name][(b, dname)] = {
                    "err": err, "ms": time_fn(lambda: kern(*args)),
                    "plain_ms": time_fn(lambda: plain(*args))}
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
                    qst, h0, seq, dtype))}
    for name, per in results.items():
        for (b, dname), r in sorted(per.items()):
            probe = (f"  h-rounding probe {r['probe_err']:.3e}, unrounded "
                     f"control {r['control_err']:.3e}"
                     if "probe_err" in r else "")
            log(f"kernel {name:16s} B={b:3d} {dname:9s} max_abs_err "
                f"{r['err']:.3e}  kernel {r['ms']:.4f} ms  plain "
                f"{r['plain_ms']:.4f} ms{probe}")
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


def write_artifacts(mcfg, out_dir: Path):
    """Seeded full-width W and fixed-EF params -> two artifact files."""
    from lctvqa import __version__
    from lctvqa.export import ARTIFACT_VERSION, save_artifact
    from lctvqa_torch import convert
    from lctvqa_torch.models import vqa_ef, vqa_w

    qst_words, ans_words = vocab_words(mcfg)
    paths = {}
    for family, seed in (("w", SEED + 1), ("ef", SEED + 2)):
        gen = torch.Generator().manual_seed(seed)
        params = (vqa_w.init_w_model(gen, mcfg) if family == "w"
                  else vqa_ef.init_ef_model(gen, mcfg)[0])
        n = sum(p.numel() for p in _leaves(params))
        meta = {"artifact_version": ARTIFACT_VERSION, "family": family,
                "int8": False, "platforms": ["cuda"],
                "img_size": mcfg.img_size, "max_qst_len": mcfg.max_qst_len,
                "qst_vocab_size": mcfg.qst_vocab_size,
                "ans_vocab_size": mcfg.ans_vocab_size,
                "arch_type": mcfg.arch_type, "epoch": None,
                "lctvqa_version": __version__, "qst_words": qst_words,
                "ans_words": ans_words}
        path = out_dir / f"{family}.lctx"
        save_artifact({"exported": {},
                       "params": {"params": convert.to_jax(params)},
                       "meta": meta}, str(path))
        log(f"artifact {family}: {n} params, "
            f"{path.stat().st_size / 2**20:.1f} MiB")
        paths[family] = str(path)
    return paths


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


def serve_run(paths, mcfg, device, flags, n_answer=48, n_generate=24,
              max_batch=64):
    """Serve both artifacts, send concurrent requests; -> responses."""
    from lctvqa_torch import serve

    qst_words, ans_words = vocab_words(mcfg)
    rng = np.random.default_rng(SEED)
    s = mcfg.img_size
    images = rng.integers(0, 256, (max(n_answer, n_generate), s, s, 3),
                          dtype=np.uint8)
    questions = [" ".join(rng.choice(qst_words[4:], 6)) for _ in images]
    servers = {}
    try:
        for family, path in paths.items():
            t0 = time.perf_counter()
            srv = serve.make_server(path, port=0, window_ms=5.0,
                                    max_batch=max_batch, device=device,
                                    compute_dtype="float32", **flags)
            calls = srv.RequestHandlerClass.service.warmup()
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            servers[family] = srv
            log(f"serve {family}: loaded and warmed {calls} calls in "
                f"{time.perf_counter() - t0:.1f} s")
        ports = {f: srv.server_address[1] for f, srv in servers.items()}

        def img_b64(i):
            return base64.b64encode(images[i].tobytes()).decode()

        jobs = [("w", "/answer", i) for i in range(n_answer)]
        jobs += [("ef", "/answer", i) for i in range(n_answer)]
        jobs += [("ef", "/generate", i) for i in range(n_generate)]

        def ask(job):
            family, path, i = job
            payload = {"image_b64": img_b64(i)}
            if path == "/answer":
                payload["question"] = questions[i]
            return _post(ports[family], path, payload)

        t0 = time.perf_counter()
        with ThreadPoolExecutor(32) as pool:
            results = list(pool.map(ask, jobs))
        wall = time.perf_counter() - t0
        health = {f: _post(p, "/healthz") for f, p in ports.items()}
    finally:
        for srv in servers.values():
            srv.shutdown()
            srv.server_close()
    out = {"w_answer": [], "ef_answer": [], "ef_generate": []}
    for (family, path, _), (status, body) in zip(jobs, results):
        expect(status == 200, f"{family} {path}: HTTP {status} {body}")
        key = f"{family}_{path[1:]}"
        out[key].append(body)
        ok = (isinstance(body.get("answer_id"), int)
              and 0 <= body["answer_id"] < mcfg.ans_vocab_size
              and body.get("answer") == ans_words[body["answer_id"]])
        if path == "/generate":
            ok = ok and isinstance(body.get("question"), str)
        expect(ok, f"{family} {path}: malformed response {body}")
    for family, (status, body) in health.items():
        expect(status == 200 and body.get("ok") is True
               and body.get("family") == family,
               f"{family} /healthz: {status} {body}")
    log(f"served {len(jobs)} requests in {wall:.2f} s "
        f"({len(jobs) / wall:.1f} req/s, 32 client threads)")
    return out


# ---------------------------------------------------------------------------
# phases 5 and 6: reference check and throughput
# ---------------------------------------------------------------------------

def check_against_cpu(paths, mcfg, device):
    from lctvqa.export import read_artifact
    from lctvqa_torch.export import ServingModel

    rng = np.random.default_rng(SEED + 3)
    s = mcfg.img_size
    u8 = rng.integers(0, 256, (2, s, s, 3), dtype=np.uint8)
    qst = rng.integers(0, mcfg.qst_vocab_size, (2, mcfg.max_qst_len),
                       dtype=np.int32)
    for family, path in paths.items():
        art = read_artifact(path)
        ref = ServingModel(art, "cpu", compute_dtype="float32")
        want = ref.answer_logits(u8, qst)
        want_gen = ref.generate(u8) if family == "ef" else None
        for fname, flags in KERNEL_FLAGS.items():
            model = ServingModel(art, device, compute_dtype="float32",
                                 **flags)
            got = model.answer_logits(u8, qst).cpu()
            err = float((got - want).abs().max())
            expect(got.shape == (2, mcfg.ans_vocab_size)
                   and bool(torch.isfinite(got).all()) and err <= LOGIT_TOL,
                   f"{family} {fname}: answer logits vs CPU max err {err}")
            log(f"{family} {fname}: answer logits vs CPU max |err| {err:.3e}")
            if want_gen is not None:
                tok, ans = (t.cpu() for t in model.generate(u8))
                expect(tok.shape == (2, mcfg.max_qst_len)
                       and torch.equal(tok, want_gen[0])
                       and torch.equal(ans, want_gen[1]),
                       f"{family} {fname}: generate differs from the CPU")
            del model
        del ref, art
    torch.cuda.empty_cache()


def throughput(paths, device, batch=64, iters=10):
    from lctvqa.export import read_artifact
    from lctvqa_torch.export import ServingModel

    rows = []
    for family, path in paths.items():
        art = read_artifact(path)
        s, seq = art["meta"]["img_size"], art["meta"]["max_qst_len"]
        rng = np.random.default_rng(SEED + 4)
        u8 = torch.from_numpy(rng.integers(0, 256, (batch, s, s, 3),
                                           dtype=np.uint8))
        qst = torch.zeros(batch, seq, dtype=torch.int32)
        for dtype in ("bfloat16", "float32"):
            for fname, flags in KERNEL_FLAGS.items():
                model = ServingModel(art, device, compute_dtype=dtype,
                                     **flags)
                fns = {"answer_logits": lambda: model.answer_logits(u8, qst)}
                if family == "ef":
                    fns["generate"] = lambda: model.generate(u8)
                for name, fn in fns.items():
                    for _ in range(2):
                        fn()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(iters):
                        fn()
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                    rows.append((family, name, dtype, fname,
                                 batch * iters / dt, 1e3 * dt / iters))
                del model
        del art
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on an NVIDIA GPU", file=sys.stderr)
        return 1
    import dataclasses

    from lctvqa.config import ModelConfig
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

    # full width: ModelConfig's defaults with the fixed VGG19 encoder
    mcfg = dataclasses.replace(ModelConfig(), arch_type="fixed")

    # 2. kernels vs plain versions, TF32 off; later phases run at
    # PyTorch's defaults, as a server does
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kern = check_kernels(device, mcfg)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    log(f"TF32 at PyTorch's defaults from here: matmul {tf32[0]}, "
        f"cuDNN {tf32[1]}")
    log(card)

    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
        # 3. artifacts
        paths = write_artifacts(mcfg, Path(tmp))

        # 4. the main path: HTTP serving, twice
        _build.reset_launch_counts()
        responses, per_run = {}, {}
        for fname, flags in KERNEL_FLAGS.items():
            before = _build.launch_counts()
            responses[fname] = serve_run(paths, mcfg, device, flags)
            after = _build.launch_counts()
            per_run[fname] = {k: after[k] - before[k] for k in after}
            log(f"launches in the {fname} run: {per_run[fname]}")
        launches = _build.launch_counts()
        for name, (_, _, run) in KERNELS.items():
            expect(per_run[run][name] > 0,
                   f"{name} never launched in the {run} serving run")
        gen_a = responses["default"]["ef_generate"]
        gen_b = responses["kernels"]["ef_generate"]
        expect(gen_a == gen_b, "greedy questions differ between the default "
               "and the kernels run")
        same = sum(a == b for a, b in zip(responses["default"]["w_answer"],
                                          responses["kernels"]["w_answer"]))
        log(f"generate responses equal across runs: {gen_a == gen_b}; W "
            f"answers equal: {same}/{len(responses['default']['w_answer'])}")

        # 5. against the CPU
        check_against_cpu(paths, mcfg, device)

        # 6. throughput (informational)
        for family, name, dtype, fname, rate, ms in throughput(paths, device):
            log(f"throughput {family} {name} B=64 {dtype} {fname}: "
                f"{rate:.1f} pairs/s ({ms:.2f} ms/batch) on {card}")

    rows = []
    for name, (source, replaces, _) in KERNELS.items():
        r = kern[name][(64, "bfloat16")]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": r["err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "shape": "B=64 bfloat16",
                     "fp32_max_abs_err": max(
                         kern[name][(b, "float32")]["err"] for b in BATCHES)})
        if "probe_err" in r:
            rows[-1]["h_rounding_probe_err"] = max(
                kern[name][(b, "bfloat16")]["probe_err"] for b in BATCHES)
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
