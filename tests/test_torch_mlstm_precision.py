"""Precision of the chunkwise-mLSTM kernel's tensor-core products, on the CPU.

The Hopper kernel (``src/repro_torch/kernels/csrc/mlstm_chunk.cu``) runs the
chunk body's Dh-wide products on the tensor cores: the inter-chunk term
Q C0, the state update (k .* wk)^T V and the intra-chunk (Q K^T .* W) V. Its
inputs are fp32, and random-weight xlstm-1.3b is ill-conditioned, so the
kernel splits each fp32 operand into bf16 pieces and sums several products.
This file emulates that operand rounding in plain PyTorch, in the port's
chunk body, and holds it to the kernel's checks (``chip_smoke.py``):

- against the fp32 plain version, tests/test_kernels.py's 3e-4 (abs + rel)
  on h and the final state;
- h's relative RMS error against an fp64 plain version within 3x of the
  fp32 plain version's own.

Emulated: the kernel's three bf16 pieces with six products (``bf16x3``), and
the alternatives it was chosen over: two bf16 pieces with three products
(``bf16x2``), 3xTF32 (``tf32x2``), and single-pass bf16 and TF32. Rounding to
bf16 is round-to-nearest-even; to TF32, round-to-nearest on the fp32 bit
pattern (10 mantissa bits kept). The products of the pieces are exact, as
on the tensor cores; the emulation sums them in fp64 and rounds the product
to fp32 once, where the tensor cores keep an fp32 sum: a slight advantage
to every mode alike.

The backward's products are emulated the same way, at the end of the file.

``PYTHONPATH=src python tests/test_torch_mlstm_precision.py`` prints the
table of every mode on every case, forward and backward (the numbers
recorded in PERF.md).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.mlstm_chunk import (BWD_FLOOR_FACTOR, BWD_TOL,  # noqa: E402
                                             backward_errors, init_state,
                                             mlstm_chunk_backward_plain, mlstm_chunk_plain)
from test_torch_cuda import _mlstm_inputs  # noqa: E402

MLSTM_TOL = 3e-4
FP64_FACTOR = 3.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The fp64 products at Dh = 1024 run on one thread: spread over every
    core, each of several test workers spins on its own thread pool, and
    the file takes tens of times longer."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _tf32(x):
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


# mode: (rounding of a piece, pieces per operand, products (i, j) of pieces)
MODES = {
    "bf16x3": (_bf16, 3, [(0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0)]),
    "bf16x2": (_bf16, 2, [(0, 0), (0, 1), (1, 0)]),
    "tf32x2": (_tf32, 2, [(0, 0), (0, 1), (1, 0)]),
    "bf16": (_bf16, 1, [(0, 0)]),
    "tf32": (_tf32, 1, [(0, 0)]),
}
KERNEL_MODE = "bf16x3"


def _pieces(x, rnd, n):
    out, rest = [], x
    for _ in range(n):
        out.append(rnd(rest))
        rest = rest - out[-1]
    return out


def _product(mode):
    """einsum of two fp32 operands as the tensor cores would take them in
    ``mode``; None: the plain fp32 einsum."""
    if mode is None:
        return torch.einsum
    rnd, n, pairs = MODES[mode]

    def mm(eq, a, b):
        pa, pb = _pieces(a, rnd, n), _pieces(b, rnd, n)
        out = sum(torch.einsum(eq, pa[i].double(), pb[j].double()) for i, j in pairs)
        return out.to(torch.float32)
    return mm


class _SplitProduct(torch.autograd.Function):
    """einsum ``eq`` of two fp32 operands through split products in ``mode``,
    forward and backward: each gradient is the product of the output's
    gradient with the other operand, split the same way, as the backward
    kernel's walks and state terms take them."""

    @staticmethod
    def forward(ctx, eq, mode, a, b):
        ctx.eq, ctx.mode = eq, mode
        ctx.save_for_backward(a, b)
        return _product(mode)(eq, a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ins, out = ctx.eq.split("->")
        x, y = ins.split(",")
        mm = _product(ctx.mode)
        return None, None, mm(f"{out},{y}->{x}", g, b), mm(f"{x},{out}->{y}", a, g)


def _split_grad_product(mode):
    """``mm`` for ``_chunk_body`` whose products are split forward and
    backward (``_SplitProduct``); None: plain einsum, as autograd has it."""
    if mode is None:
        return torch.einsum
    return lambda eq, a, b: _SplitProduct.apply(eq, mode, a, b)


def _chunk_body(q, k, v, li, lf, C0, n0, m0, mm, mm_local=None):
    """The port's chunk body (kernels/mlstm_chunk.py ``_chunk_body``) with its
    three tensor-core products through ``mm`` (the intra-chunk one through
    ``mm_local`` where given); all else as the plain version."""
    L = q.shape[2]
    F = torch.cumsum(lf, dim=-1)
    g = li - F
    run = torch.maximum(m0[..., None], torch.cummax(g, dim=-1).values)
    m = F + run
    logw = (F - m)[..., :, None] + g[..., None, :]
    mask = torch.ones(L, L, dtype=torch.bool).tril()
    W = torch.exp(torch.where(mask, logw, float("-inf")))   # finite gradients, as the plain's
    scores = torch.einsum("bhtd,bhsd->bhts", q, k) * W
    h_num = (mm_local or mm)("bhts,bhsd->bhtd", scores, v)
    n_intra = torch.einsum("bhts,bhsd->bhtd", W, k)
    w_state = torch.exp(F + m0[..., None] - m)
    h_num = h_num + w_state[..., None] * mm("bhtd,bhde->bhte", q, C0)
    n_t = n_intra + w_state[..., None] * n0[..., None, :]
    denom = torch.einsum("bhtd,bhtd->bht", q, n_t).abs()
    h = h_num / torch.maximum(denom, torch.exp(-m))[..., None]
    m_L = m[..., -1]
    wk = torch.exp((F[..., -1:] - F) + li - m_L[..., None])
    decay = torch.exp(F[..., -1] + m0 - m_L)
    kw = k * wk[..., None]
    C = decay[..., None, None] * C0 + mm("bhsd,bhse->bhde", kw, v)
    n = decay[..., None] * n0 + kw.sum(2)
    return h, (C, n, m_L)


def _scan(args, chunk, state, mode, mm=None, mm_local=None):
    q, k, v, li, lf = args
    C, n, m = state["C"], state["n"], state["m"]
    if mm is None:
        mm = _product(mode) if q.dtype == torch.float32 else torch.einsum
    hs = []
    for t0 in range(0, q.shape[2], chunk):
        sl = slice(t0, t0 + chunk)
        h, (C, n, m) = _chunk_body(q[:, :, sl], k[:, :, sl], v[:, :, sl], li[:, :, sl],
                                   lf[:, :, sl], C, n, m, mm, mm_local)
        hs.append(h)
    return torch.cat(hs, dim=2), {"C": C, "n": n, "m": m}


# (B, H, S, Dh, chunk, carried-in state, inputs): chip_smoke.py's MLSTM_CASES
# at sizes a CPU emulation in fp64 takes in seconds
CASES = [
    (1, 2, 64, 32, 16, False, None),
    (2, 3, 128, 64, 32, False, None),
    (1, 4, 128, 128, 64, False, None),
    (2, 2, 96, 32, 32, False, None),
    (2, 2, 128, 64, 32, True, None),
    (1, 2, 100, 64, 32, False, None),
    (1, 2, 70, 1024, 64, True, None),
    (1, 2, 256, 128, 64, True, "forget"),
    (1, 2, 256, 128, 64, True, "cancel"),
    (2, 2, 128, 64, 32, True, "cancel"),
    (1, 1, 256, 1024, 64, True, "cancel"),
]
CASE_IDS = ["-".join(map(str, c[:5])) + ("-carried" if c[5] else "") + (f"-{c[6]}" if c[6]
            else "") for c in CASES]


def _measure(case, modes):
    """{mode: (max scaled error against fp32 plain over h, C, n, m; h's
    relative RMS error against fp64)} and plain's relative RMS against fp64."""
    B, H, S, Dh, chunk, carry, kind = case
    args = _mlstm_inputs(S + Dh, B, H, S, Dh, "cpu", kind)
    state = init_state(B, H, Dh, "cpu")
    if carry:
        _, state = _scan(_mlstm_inputs(1, B, H, 48, Dh, "cpu", kind), chunk, state, None)
    h32, s32 = _scan(args, chunk, state, None)
    h64, _ = _scan([a.double() for a in args], chunk,
                   {key: val.double() for key, val in state.items()}, None)
    rel = lambda h: ((h.double() - h64).norm() / h64.norm()).item()  # noqa: E731
    out = {}
    for mode in modes:
        h, s = _scan(args, chunk, state, mode)
        scaled = max(((a - b).abs() / (MLSTM_TOL * (1 + b.abs()))).max().item()
                     for a, b in [(h, h32)] + [(s[x], s32[x]) for x in "Cnm"])
        out[mode] = (scaled, rel(h))
    return out, rel(h32)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_kernel_split_holds_the_kernel_checks(case):
    """Three bf16 pieces, six products: within 3e-4 of the fp32 plain version
    and, against fp64, within 3x of the plain version's own error."""
    got, plain64 = _measure(case, [KERNEL_MODE])
    scaled, rel64 = got[KERNEL_MODE]
    assert scaled <= 1.0, f"{KERNEL_MODE}: {scaled:.3f} of the tolerance"
    assert rel64 <= FP64_FACTOR * plain64, (rel64, plain64)


@pytest.mark.parametrize("mode", ["bf16", "tf32"])
def test_single_pass_products_break_the_tolerance(mode):
    """One pass in bf16 or TF32 (8 or 11 significant bits, dot products of
    up to Dh terms) misses 3e-4 even on well-conditioned random inputs, so
    the kernel uses no such product."""
    got, _ = _measure(CASES[2], [mode])
    assert got[mode][0] > 1.0


def test_two_bf16_pieces_fall_short_against_fp64():
    """Two bf16 pieces (16 bits, three products) hold 3e-4 on random inputs,
    but their h error against fp64 is several times the plain version's:
    the reason for a third piece."""
    got, plain64 = _measure(CASES[2], ["bf16x2"])
    scaled, rel64 = got["bf16x2"]
    assert scaled <= 1.0
    assert rel64 > FP64_FACTOR * plain64


@pytest.mark.parametrize("case", [CASES[2], CASES[9]], ids=[CASE_IDS[2], CASE_IDS[9]])
def test_3xtf32_alternative_holds_the_checks(case):
    """3xTF32 would hold them too; the kernel takes bf16 pieces because TF32
    wgmma reads only K-major operands and its register fragments are not the
    accumulator's layout, which the kernel's state-in-registers design
    relies on (see the .cu's head note)."""
    got, plain64 = _measure(case, ["tf32x2"])
    scaled, rel64 = got["tf32x2"]
    assert scaled <= 1.0
    assert rel64 <= FP64_FACTOR * plain64


@pytest.mark.parametrize("case", [CASES[i] for i in (4, 5, 9)],
                         ids=[CASE_IDS[i] for i in (4, 5, 9)])
def test_fp32_baseline_is_the_package_plain_version(case):
    """The study's fp32 baseline, this file's copy of the chunk body, is the
    package's plain version bit for bit: the study describes what the kernel
    is held to."""
    B, H, S, Dh, chunk, carry, kind = case
    args = _mlstm_inputs(S + Dh, B, H, S, Dh, "cpu", kind)
    state = init_state(B, H, Dh, "cpu")
    if carry:
        _, state = mlstm_chunk_plain(*_mlstm_inputs(1, B, H, 48, Dh, "cpu", kind), chunk=chunk)
    h, st = _scan(args, chunk, state, None)
    hp, stp = mlstm_chunk_plain(*args, chunk=chunk, state=state)
    assert torch.equal(h, hp)
    assert all(torch.equal(st[key], stp[key]) for key in ("C", "n", "m"))


def test_operand_splits_are_exact_to_their_bits():
    """The pieces add up to the operand within each mode's bits."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(np.float32))
    for mode, bound in (("bf16x3", 2.0 ** -24), ("bf16x2", 2.0 ** -16), ("tf32x2", 2.0 ** -21)):
        rnd, n, _ = MODES[mode]
        rest = (x.double() - sum(p.double() for p in _pieces(x, rnd, n))).abs()
        assert (rest <= bound * x.double().abs()).all(), mode


# ------------------------------------------------------------ the backward
# The backward kernel (csrc/mlstm_chunk_bwd.cu) takes its Dh^2-sized products
# to the tensor cores the same way: the chunk-start states (the update
# (k .* wk)^T V again), the reverse walk of dC (the update sum_t (w_t q_t /
# D_t) dh_t^T) and the state terms C0 dN, dC v and dC^T k, every fp32 operand
# in pieces; its L x L terms stay in fp32 on CUDA cores. Emulated here by
# autograd of the chunk body with its two state products split forward and
# backward (``_SplitProduct``: each gradient of Q C0 and of (k .* wk)^T V is
# itself a split product) and the intra-chunk product plain, and held as the
# kernel is (kernels/mlstm_chunk.py): BWD_TOL of each gradient's max against
# autograd of the fp32 plain version; on the "cancel" inputs, against fp64,
# within max(BWD_TOL, BWD_FLOOR_FACTOR x the fp32 plain version's error).
BWD_CASES = CASES + [(1, 2, 128, 96, 64, True, "floor")]
BWD_IDS = CASE_IDS + ["1-2-128-96-64-carried-floor"]


def _bwd_measure(case, modes):
    """{mode: (max over the gradients of |err| / max |g| against fp32 plain
    autograd, max over them of the fp64 error over its limit)}, the inputs
    and gradients chip_smoke.py's phase 10a draws, on the CPU."""
    B, H, S, Dh, chunk, carry, kind = case
    args = _mlstm_inputs(S + Dh + 1, B, H, S, Dh, "cpu", kind)
    rng = np.random.default_rng(S + Dh + 2)
    normal = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    state = dstate = None
    if carry:
        _, state = mlstm_chunk_plain(*_mlstm_inputs(2, B, H, 48, Dh, "cpu", kind), chunk=chunk)
        dstate = (normal(B, H, Dh, Dh), normal(B, H, Dh), normal(B, H))
    dh = normal(B, H, S, Dh)
    ds = dict(zip(("dC", "dn", "dm"), dstate or (None,) * 3))
    ref = mlstm_chunk_backward_plain(*args, dh, chunk=chunk, state=state, **ds)
    f64 = lambda t: None if t is None else t.double()  # noqa: E731
    ref64 = mlstm_chunk_backward_plain(
        *map(f64, args), f64(dh), chunk=chunk,
        state=None if state is None else {key: f64(t) for key, t in state.items()},
        **{key: f64(t) for key, t in ds.items()})
    floor = backward_errors(ref, ref64)
    limit = {key: max(BWD_TOL, BWD_FLOOR_FACTOR * e) for key, e in floor.items()}
    out = {}
    for mode in modes:
        ins = [t.clone().requires_grad_() for t in args]
        st = None if state is None else {key: t.clone().requires_grad_()
                                         for key, t in state.items()}
        h, fin = _scan(ins, chunk, st or init_state(B, H, Dh, "cpu"), None,
                       mm=_split_grad_product(mode), mm_local=torch.einsum)
        outs, grads = [h], [dh]
        if dstate is not None:
            outs += [fin[key] for key in "Cnm"]
            grads += list(dstate)
        wrt = ins + ([] if st is None else [st[key] for key in "Cnm"])
        got = tuple(torch.autograd.grad(outs, wrt, grads)) + ((None,) * 3 if st is None else ())
        e32, e64 = backward_errors(got, ref), backward_errors(got, ref64)
        out[mode] = (max(e32.values()), max(e64[key] / limit[key] for key in e64))
    return out


@pytest.mark.parametrize("case", BWD_CASES, ids=BWD_IDS)
def test_backward_split_holds_the_backward_tolerances(case):
    """Three bf16 pieces, six products, in every Dh^2-sized product of the
    backward: BWD_TOL against fp32 plain autograd, and on the "cancel"
    inputs within the fp64 limit."""
    err32, over64 = _bwd_measure(case, [KERNEL_MODE])[KERNEL_MODE]
    if case[6] == "cancel":
        assert over64 <= 1.0, over64
    else:
        assert err32 <= BWD_TOL, err32


@pytest.mark.parametrize("case", [BWD_CASES[i] for i in (2, 4, 9)],
                         ids=[BWD_IDS[i] for i in (2, 4, 9)])
def test_two_bf16_pieces_in_the_backward(case):
    """Two bf16 pieces (three products) do not fall short of the backward's
    tolerances at these sizes, but lie 12-31x further from the fp32 plain
    version than three (PERF.md: 0.46 of the fp64 limit against 0.31 at
    the training length): the kernel keeps three."""
    got = _bwd_measure(case, ["bf16x2", KERNEL_MODE])
    err2, over2 = got["bf16x2"]
    assert err2 <= BWD_TOL and over2 <= 1.0, got
    assert err2 > 5.0 * got[KERNEL_MODE][0], got


if __name__ == "__main__":
    modes = list(MODES)
    print("case | plain fp32 vs fp64 | " + " | ".join(
        f"{m}: scaled err vs plain, h vs fp64" for m in modes))
    for case, cid in zip(CASES, CASE_IDS):
        got, plain64 = _measure(case, modes)
        print(f"{cid} | {plain64:.2e} | " + " | ".join(
            f"{got[m][0]:.3f}, {got[m][1]:.2e}" for m in modes), flush=True)
    print("backward case | " + " | ".join(
        f"{m}: err vs fp32 plain, fp64 error / limit" for m in ("bf16x3", "bf16x2")))
    for case, cid in zip(BWD_CASES, BWD_IDS):
        got = _bwd_measure(case, ["bf16x3", "bf16x2"])
        print(f"{cid} | " + " | ".join(f"{got[m][0]:.2e}, {got[m][1]:.3f}"
                                      for m in ("bf16x3", "bf16x2")), flush=True)
