"""Plain PyTorch reference of the LCT-VQA models and their training steps.

Written from the published models, independent of the program: the
PC-DARTS search network (partial channels 1/k, edge betas softmaxed per
node, channel shuffle, affine-free batch-statistics BatchNorm), the EF
question generator (an LSTM whose h0 and c0 are the image embedding, a
teacher-forced vocabulary head and an answer head), the W answerer
(VGG19 with its classifier's last layer removed, frozen; an LSTM
question encoder; elementwise fusion) and Adam after a global-norm clip.
It reads the parameter trees by name (linear weights [in, out], conv
weights OIHW) and imports nothing of the program.

It computes in float32 in NCHW, with TF32 off (`exact_matmuls`), unless
a `Numerics` rounds the operands of every product: that is the control
(float8 e4m3 with a per-tensor scale, the precision below the
configuration's bfloat16).

Dropout draws its masks as `torch.rand(shape, generator=g) < keep`, one
draw per dropout in the order of the forward, so a reference given a
generator seeded as the program's draws the program's masks.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

f32 = torch.float32
PRIMITIVES = ("none", "max_pool_3x3", "avg_pool_3x3", "skip_connect",
              "sep_conv_3x3", "sep_conv_5x5", "dil_conv_3x3", "dil_conv_5x5")
VGG19_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M")
OUTPUT_SIZE = 7
START_TOKEN = 2
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BN_EPS = 1e-5


@contextlib.contextmanager
def exact_matmuls():
    """float32 products without TF32, in cuBLAS and cuDNN."""
    mm, dnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = dnn


class Numerics:
    """How the operands of a product are rounded: None keeps float32;
    "fp8" rounds to float8 e4m3 with a per-tensor scale (abs-max to 448),
    "bf16" to bfloat16. The rounding passes the gradient straight through,
    so a backward multiplies by the rounded operands the forward used."""

    def __init__(self, operand: Optional[str] = None):
        if operand not in (None, "fp8", "bf16"):
            raise ValueError(f"unknown operand rounding {operand!r}")
        self.operand = operand

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.operand is None:
            return t
        with torch.no_grad():
            if self.operand == "bf16":
                r = t.to(torch.bfloat16).to(f32)
            else:
                s = torch.clamp_min(t.abs().amax(), 1e-30) / 448.0
                r = (t / s).to(torch.float8_e4m3fn).to(f32) * s
        return t + (r - t).detach() if t.requires_grad else r


EXACT = Numerics()


# --------------------------------------------------------------------------
# primitives (NCHW)
# --------------------------------------------------------------------------

def normalize(u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> ImageNet-normalized float32 NCHW."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=f32, device=u8.device)
    std = torch.tensor(IMAGENET_STD, dtype=f32, device=u8.device)
    return ((u8.to(f32) / 255.0 - mean) / std).permute(0, 3, 1, 2)


def conv(q: Numerics, p: dict, x, stride=1, padding=0, dilation=1,
         groups=1):
    return F.conv2d(q(x), q(p["w"]), p.get("b"), stride, padding, dilation,
                    groups)


def linear(q: Numerics, p: dict, x):
    return q(x) @ q(p["w"]) + p["b"]


def bn(x, scale=None, bias=None):
    """Batch-statistics BatchNorm over (N, H, W), biased variance."""
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
    y = (x - mean) / torch.sqrt(var + BN_EPS)
    if scale is not None:
        y = y * scale.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)
    return y


def dropout(x, rate: float, gen: Optional[torch.Generator]):
    if gen is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def l2_normalize(x):
    return x / x.detach().square().sum(-1, keepdim=True).sqrt()


def lstm(q: Numerics, layer: dict, xs, h=None, c=None):
    """One LSTM layer, gates (i, f, g, o); xs [B, T, E] -> (outs [B, T,
    H], h_n, c_n)."""
    b, hid = xs.shape[0], layer["w_hh"].shape[0]
    if h is None:
        h = xs.new_zeros(b, hid)
        c = xs.new_zeros(b, hid)
    w_ih, w_hh = q(layer["w_ih"]), q(layer["w_hh"])
    bias = layer["b_ih"] + layer["b_hh"]
    outs = []
    for t in range(xs.shape[1]):
        gates = q(xs[:, t]) @ w_ih + q(h) @ w_hh + bias
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    return torch.stack(outs, 1), h, c


# --------------------------------------------------------------------------
# the PC-DARTS search network
# --------------------------------------------------------------------------

def factorized_reduce(q, p, x):
    y = torch.relu(x)
    return bn(torch.cat([conv(q, p["conv1"], y, stride=2),
                         conv(q, p["conv2"], y[:, :, 1:, 1:], stride=2)], 1))


def primitive(q, prim: str, p: dict, x, stride: int):
    if prim == "none":
        return None
    if prim == "max_pool_3x3":
        return bn(F.max_pool2d(x, 3, stride, 1))
    if prim == "avg_pool_3x3":
        return bn(F.avg_pool2d(x, 3, stride, 1, count_include_pad=False))
    if prim == "skip_connect":
        return x if stride == 1 else factorized_reduce(q, p, x)
    k = int(prim[-1])
    ch = x.shape[1]
    if prim.startswith("sep_conv"):
        y = conv(q, p["dw1"], torch.relu(x), stride, k // 2, groups=ch)
        y = torch.relu(bn(conv(q, p["pw1"], y)))
        y = conv(q, p["dw2"], y, 1, k // 2, groups=ch)
        return bn(conv(q, p["pw2"], y))
    y = conv(q, p["dw"], torch.relu(x), stride, k - 1, dilation=2, groups=ch)
    return bn(conv(q, p["pw"], y))


def channel_shuffle(x, groups: int):
    n, c, h, w = x.shape
    return (x.reshape(n, groups, c // groups, h, w).transpose(1, 2)
            .reshape(n, c, h, w))


def mixed_op(q, p: dict, x, alphas, stride: int, k: int):
    """The weighted primitives on the first C/k channels, the rest passed
    (max-pooled on a reduction edge), concatenated (shuffled by the
    caller, once per node)."""
    cs = x.shape[1] // k
    part, rest = x[:, :cs], x[:, cs:]
    mix = None
    for i, prim in enumerate(PRIMITIVES):
        y = primitive(q, prim, p[prim], part, stride)
        if y is None:
            continue
        mix = alphas[i] * y if mix is None else mix + alphas[i] * y
    if stride != 1:
        rest = F.max_pool2d(rest, 2, 2)
    return torch.cat([mix, rest], 1)


def cell_schedule(m: dict) -> List[dict]:
    c_curr = m["darts_stem_multiplier"] * m["darts_init_ch"]
    c_pp = c_p = c_curr
    c_curr = m["darts_init_ch"]
    out, red_prev = [], False
    layers = m["darts_layers"]
    for i in range(layers):
        red = i in (layers // 3, 2 * layers // 3)
        if red:
            c_curr *= 2
        out.append(dict(c_pp=c_pp, c_p=c_p, c=c_curr, reduction=red,
                        reduction_prev=red_prev))
        red_prev = red
        c_pp, c_p = c_p, m["darts_multiplier"] * c_curr
    return out


def node_betas(betas, steps: int):
    out, start = [], 0
    for i in range(steps):
        out.append(torch.softmax(betas[start:start + 2 + i], 0))
        start += 2 + i
    return torch.cat(out)


def supernet(q, p: dict, arch: dict, m: dict, x):
    """x NCHW -> [B, C * 49] pooled features, flattened channel-major."""
    steps, k = m["darts_steps"], m["darts_partial_k"]
    s = conv(q, p["stem_conv"], x, padding=1)
    s0 = s1 = bn(s, p["stem_bn"]["scale"], p["stem_bn"]["bias"])
    weights = {False: (torch.softmax(arch["alphas_normal"], -1),
                       node_betas(arch["betas_normal"], steps)),
               True: (torch.softmax(arch["alphas_reduce"], -1),
                      node_betas(arch["betas_reduce"], steps))}
    for cp, spec in zip(p["cells"], cell_schedule(m)):
        alphas, betas = weights[spec["reduction"]]

        def cell(s0, s1, cp, alphas, betas, spec=spec):
            t0 = (factorized_reduce(q, cp["pre0"], s0)
                  if spec["reduction_prev"]
                  else bn(conv(q, cp["pre0"]["conv"], torch.relu(s0))))
            t1 = bn(conv(q, cp["pre1"]["conv"], torch.relu(s1)))
            states, off = [t0, t1], 0
            for _ in range(steps):
                node = None
                for j, h in enumerate(states):
                    stride = 2 if spec["reduction"] and j < 2 else 1
                    y = betas[off + j] * mixed_op(q, cp["ops"][off + j], h,
                                                  alphas[off + j], stride, k)
                    node = y if node is None else node + y
                off += len(states)
                states.append(channel_shuffle(node, k))
            return torch.cat(states[-m["darts_multiplier"]:], 1)

        if torch.is_grad_enabled():
            # each cell recomputed in the backward, so that the float32
            # network at the cell's batch fits beside nothing else
            s0, s1 = s1, checkpoint(cell, s0, s1, cp, alphas, betas,
                                    use_reentrant=False)
        else:
            s0, s1 = s1, cell(s0, s1, cp, alphas, betas)
    return F.adaptive_avg_pool2d(s1, OUTPUT_SIZE).flatten(1)


def vgg19(q, p: dict, x, gen):
    i = 0
    for v in VGG19_CFG:
        if v == "M":
            x = F.max_pool2d(x, 2, 2)
        else:
            x = torch.relu(conv(q, p["features"][i], x, padding=1))
            i += 1
    x = F.adaptive_avg_pool2d(x, OUTPUT_SIZE).flatten(1)
    x = dropout(torch.relu(linear(q, p["fc6"], x)), 0.5, gen)
    return dropout(torch.relu(linear(q, p["fc7"], x)), 0.5, gen)


# --------------------------------------------------------------------------
# the EF and W models
# --------------------------------------------------------------------------

def answer_head(q, p, img_feat, qst_feat, rate: float, gen):
    x = dropout(torch.tanh(img_feat * qst_feat), rate, gen)
    x = dropout(torch.tanh(linear(q, p["fc1"], x)), rate, gen)
    return linear(q, p["fc2"], x)


def ef_image(q, p, arch, m, img):
    return l2_normalize(linear(q, p["img_fc"], supernet(q, p["darts"], arch,
                                                        m, img)))


def ef_encode(q, p, img_feat, qst):
    """Teacher-forced question encoder -> (qst feature, logits [B, T, V])."""
    qp = p["qst"]
    x = torch.tanh(qp["word2vec"]["table"][qst.long()])
    outs, h, c = lstm(q, qp["lstm"]["layers"][0], x, img_feat, img_feat)
    feat = linear(q, qp["fc1"], torch.tanh(torch.cat([h, c], 1)))
    return feat, linear(q, qp["fc2"], torch.tanh(outs))


def ef_forward(q, p, arch, m, img, qst, gen):
    """-> (answer logits, question logits)."""
    img_feat = ef_image(q, p, arch, m, img)
    qst_feat, logits = ef_encode(q, p, img_feat, qst)
    return (answer_head(q, p, img_feat, qst_feat, m["dropout_rate"], gen),
            logits)


def decode_logits(q, p, img_feat, tokens):
    """The decoder's logits at each position, fed the given tokens: step 0
    from tanh(embed(<start>)), step t from embed(tokens[:, t-1]) (no
    tanh: the generator's own rule) -> [B, T, V]."""
    qp = p["qst"]
    table = qp["word2vec"]["table"]
    b, t = tokens.shape
    start = torch.tanh(table[torch.full((b,), START_TOKEN,
                                        device=tokens.device)])
    xs = torch.cat([start[:, None], table[tokens[:, :t - 1].long()]], 1)
    outs, _, _ = lstm(q, qp["lstm"]["layers"][0], xs, img_feat, img_feat)
    return linear(q, qp["fc2"], torch.tanh(outs))


def sample_tokens(q, p, img_feat, max_len: int, temperature: float,
                  gen: Optional[torch.Generator]):
    """The decoder's own questions: a draw from softmax(logits /
    temperature) at each step (the first maximum where `gen` is None),
    the next step fed the drawn token's embedding -> int32 [B, T]."""
    qp = p["qst"]
    table = qp["word2vec"]["table"]
    layer = qp["lstm"]["layers"][0]
    b = img_feat.shape[0]
    x = torch.tanh(table[torch.full((b,), START_TOKEN,
                                    device=img_feat.device)])
    h = c = img_feat
    toks = []
    for _ in range(max_len):
        _, h, c = lstm(q, layer, x[:, None], h, c)
        logits = linear(q, qp["fc2"], torch.tanh(h))
        if gen is None:
            tok = logits.argmax(-1)
        else:
            tok = torch.multinomial(torch.softmax(logits / temperature, -1),
                                    1, generator=gen)[:, 0]
        toks.append(tok)
        x = table[tok]
    return torch.stack(toks, 1).to(torch.int32)


def w_forward(q, p, m, img, qst, gen):
    feat = vgg19(q, p["vgg"], img, gen)
    img_feat = l2_normalize(linear(q, p["img_fc"], feat))
    qp = p["qst"]
    x = torch.tanh(qp["word2vec"]["table"][qst.long()])
    _, h, c = lstm(q, qp["lstm"]["layers"][0], x)
    qst_feat = linear(q, qp["fc"], torch.tanh(torch.cat([h, c], 1)))
    return answer_head(q, p, img_feat, qst_feat, m["dropout_rate"], gen)


# --------------------------------------------------------------------------
# losses and the optimizer
# --------------------------------------------------------------------------

def cross_entropy(logits, labels):
    return F.cross_entropy(logits, labels.long())


def soft_xent(logits, target):
    return -(target * torch.log_softmax(logits, -1)).sum() / logits.shape[0]


def leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(rebuild(v, it) for v in tree)
    return next(it)


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8 outside the root, both moments
    bias-corrected) after clipping the global gradient norm to `clip`
    (scale clip / max(norm, clip))."""

    def __init__(self, tree, lr: float, clip: float):
        self.lr, self.clip, self.step = lr, clip, 0
        self.m = [torch.zeros_like(t) for t in leaves(tree)]
        self.v = [torch.zeros_like(t) for t in leaves(tree)]

    @torch.no_grad()
    def update(self, tree, grads: Sequence[Optional[torch.Tensor]]):
        ps = leaves(tree)
        gs = [torch.zeros_like(p) if g is None else g
              for p, g in zip(ps, grads)]
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in gs)).float()
        scale = self.clip / torch.clamp(norm, min=self.clip)
        gs = [g * scale for g in gs]
        self.step += 1
        c1, c2 = 1 - 0.9 ** self.step, 1 - 0.999 ** self.step
        out = []
        for i, (p, g) in enumerate(zip(ps, gs)):
            self.m[i] = 0.9 * self.m[i] + 0.1 * g
            self.v[i] = 0.999 * self.v[i] + 0.001 * g * g
            out.append(p - self.lr * (self.m[i] / c1)
                       / (torch.sqrt(self.v[i] / c2) + 1e-8))
        return rebuild(tree, iter(out)), gs


def grads_of(loss, tree):
    ps = leaves(tree)
    live = [p for p in ps if p.requires_grad]
    got = iter(torch.autograd.grad(loss, live, allow_unused=True))
    return [next(got) if p.requires_grad else None for p in ps]


def with_grad(tree, frozen=()):
    """Fresh leaves that require a gradient, except the subtrees named in
    `frozen`."""
    return {k: (rebuild(v, iter([t.detach() for t in leaves(v)]))
                if k in frozen else
                rebuild(v, iter([t.detach().requires_grad_()
                                 for t in leaves(v)])))
            for k, v in tree.items()}


def stage1(q, ef, arch, m, opt: Adam, img, qst, labels, gen):
    """The EF's step: answer CE + shifted teacher-forcing CE (pad targets
    included) -> (new params, loss, the clipped gradient)."""
    p = with_grad(ef)
    ans, logits = ef_forward(q, p, arch, m, img, qst, gen)
    v = logits.shape[-1]
    loss = (cross_entropy(ans, labels)
            + cross_entropy(logits[:, :-1].reshape(-1, v),
                            qst[:, 1:].reshape(-1)))
    new, g = opt.update(ef, grads_of(loss, p))
    return new, float(loss.detach()), g


def stage2(q, w, ef, arch, m, opt: Adam, img, qst, labels, pseudo_qst, gen,
           w_lambda: float, img_feat=None):
    """W's step on the real pairs and on the EF's questions (given) with
    the EF's softened answers to them (its dropout on), VGG frozen ->
    (new params, loss, the clipped gradient). `img_feat`: the EF's image
    embedding of `img`, where the caller has it."""
    with torch.no_grad():
        if img_feat is None:
            img_feat = ef_image(q, ef, arch, m, img)
        qst_feat, _ = ef_encode(q, ef, img_feat, pseudo_qst)
        pseudo_ans = torch.softmax(answer_head(q, ef, img_feat, qst_feat,
                                               m["dropout_rate"], gen), -1)
    p = with_grad(w, frozen=("vgg",))
    out1 = w_forward(q, p, m, img, qst, gen)
    out2 = w_forward(q, p, m, img, pseudo_qst, gen)
    loss = cross_entropy(out1, labels) + w_lambda * soft_xent(out2,
                                                              pseudo_ans)
    new, g = opt.update(w, grads_of(loss, p))
    return new, float(loss.detach()), g


def leaf_names(tree, prefix="") -> List[str]:
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in leaf_names(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}{i}/")]
    return [prefix.rstrip("/")]


def log_probs_at(q, ef, arch, m, img, tokens, temperature: float = 1.0):
    """log softmax(logits / temperature) of the decoder fed `tokens`, at
    every position -> [B, T, V]."""
    img_feat = ef_image(q, ef, arch, m, img)
    return torch.log_softmax(decode_logits(q, ef, img_feat, tokens)
                             / temperature, -1)
