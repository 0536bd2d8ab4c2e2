"""Every kernel wrapper takes the operands the reference takes.

The JAX kernels take any array; the port's kernels read contiguous memory,
and the GEMMs, the attention, the LayerNorm and the softmax also a 16-byte
aligned address.  Each wrapper passes its operands through
``_build.operands``: one that the kernel cannot read in place becomes one
contiguous copy, counted in ``_build.operand_copies`` and not in the launch
counts, and the kernel runs on it.  The transpose and the paged decodes
narrow their words to an unaligned address instead, and copy only a view
that is not contiguous.  ``paged_copy`` writes the caller's pool in place,
so it refuses a pool that is not contiguous rather than write a copy.

On the CPU each wrapper takes its plain version: a strided view gives the
answer of its contiguous copy, bit for bit.  The cases marked ``cuda`` hold
the kernel on a view, or on an operand 4 bytes off a 16-byte address,
against the kernel on the contiguous copy, bit for bit, with the copy
counter up by exactly the operands that needed one.  No JAX here: the
``cuda`` cases run with ``--noconftest``.  Inputs come from a numpy seed.
"""
import contextlib

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import repro_torch.kernels as tk
from repro_torch.kernels import _build


@pytest.fixture(autouse=True)
def _fresh_counts():
    tk.reset_launch_counts()
    yield
    tk.reset_launch_counts()


@pytest.fixture
def cuda_card():
    """Skip unless a Hopper-class card (capability >= 9.0) is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _paged(seed, B, maxp, page, seq_pos):
    """A scattered page table (null page 0 past each seq_pos) and seq_pos."""
    rng = np.random.default_rng(seed)
    table = np.zeros((B, maxp), np.int32)
    phys = rng.permutation(np.arange(1, B * maxp + 1))
    for b, pos in enumerate(seq_pos):
        table[b, :pos // page + 1] = phys[b * maxp:b * maxp + pos // page + 1]
    return [torch.from_numpy(table), torch.tensor(seq_pos, dtype=torch.int32)]


# wrapper: (call, operands(dtype) -> list, the dtypes it takes, whether its
# kernel needs a 16-byte address)
CASES = {
    "bwma_gemm": (lambda a, b: tk.bwma_gemm(a, b),
                  lambda dt: [_rand(1, 2, 3, 16, 16).to(dt), _rand(2, 3, 2, 16, 16).to(dt)],
                  True),
    "bwma_fused_ffn": (lambda a, w, c: tk.bwma_fused_ffn(a, w, c),
                       lambda dt: [_rand(3, 2, 2, 3, 16, 16).to(dt),
                                   _rand(4, 3, 2, 16, 16).to(dt), _rand(5, 2, 16).to(dt)],
                       True),
    "rwma_gemm": (lambda a, b: tk.rwma_gemm(a, b, bm=16, bk=16, bn=16),
                  lambda dt: [_rand(6, 32, 48).to(dt), _rand(7, 48, 32).to(dt)], True),
    "bwma_attention": (lambda q, k, v: tk.bwma_attention(q, k, v, scale=0.3, s_logical=30),
                       lambda dt: [_rand(s, 2, 2, 2, 16, 16).to(dt) for s in (8, 9, 10)],
                       True),
    "bwma_layernorm": (lambda x, g, b: tk.bwma_layernorm(x, g, b, 28),
                       lambda dt: [_rand(11, 2, 3, 2, 16, 16).to(dt), _rand(12, 2, 16).to(dt),
                                   _rand(13, 2, 16).to(dt)],
                       True),
    "bwma_softmax": (lambda x: tk.bwma_softmax(x, 28),
                     lambda dt: [(_rand(14, 2, 3, 2, 16, 16) * 3).to(dt)], True),
    "bwma_transpose": (lambda x: tk.bwma_transpose(x),
                       lambda dt: [_rand(15, 2, 3, 2, 16, 8).to(dt)], False),
    "paged_attention_decode": (
        lambda q, k, v, t, s: tk.paged_attention_decode(q, k, v, t, s),
        lambda dt: [_rand(16, 3, 1, 8, 32).to(dt), _rand(17, 13, 16, 2, 32).to(dt),
                    _rand(18, 13, 16, 2, 32).to(dt)] + _paged(19, 3, 4, 16, [0, 17, 63]),
        False),
    "mla_paged_attention_decode": (
        lambda ql, qr, c, k, t, s: tk.mla_paged_attention_decode(ql, qr, c, k, t, s, scale=0.2),
        lambda dt: [_rand(20, 3, 1, 20, 32).to(dt), _rand(21, 3, 1, 20, 8).to(dt),
                    _rand(22, 13, 16, 32).to(dt), _rand(23, 13, 16, 8).to(dt)]
        + _paged(24, 3, 4, 16, [0, 17, 63]),
        False),
}
DTYPES = (torch.float32, torch.bfloat16)


def _strided(t):
    """The same values as a view that is not contiguous (every other element
    of a wider buffer)."""
    return torch.stack([t, torch.zeros_like(t)], -1)[..., 0]


def _offset(t):
    """The same values, contiguous, 4 bytes past a 16-byte address."""
    off = 4 // t.element_size()
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)[off:]
    return buf.view(t.shape).copy_(t)


def _which(kernel):
    """Which operands a case passes as a view: all of them, then each alone."""
    n = len(CASES[kernel][1](torch.float32))
    return ["all"] + list(range(n))


PARAMS = [(k, w) for k in CASES for w in _which(k)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel,which", PARAMS)
def test_a_view_gives_the_answer_of_its_copy(kernel, which, dtype):
    call, make, _ = CASES[kernel]
    args = make(dtype)
    views = [_strided(a) if which in ("all", i) else a for i, a in enumerate(args)]
    assert any(not v.is_contiguous() for v in views)
    assert torch.equal(call(*views), call(*args))
    assert tk.launch_counts() == dict.fromkeys(tk.launch_counts(), 0)


def test_operands_copies_only_what_the_kernel_cannot_read():
    a = _rand(30, 4, 8)
    copies = _build.operand_copies
    same, none = _build.operands(a, None, aligned=True)
    assert same is a and none is None and _build.operand_copies == copies
    view, = _build.operands(a.t())
    assert view.is_contiguous() and torch.equal(view, a.t()) and _build.operand_copies == copies + 1
    # off a 16-byte address on the CPU: no kernel reads it, nothing to copy
    off = _offset(a)
    assert _build.operands(off, aligned=True)[0] is off and _build.operand_copies == copies + 1


def test_paged_copy_refuses_a_view_and_says_why(monkeypatch):
    """The copy is made in place: a contiguous copy of the pool would take
    it instead of the caller's pool, so a view is refused on the card (the
    CPU's plain version writes through the view)."""
    calls = []
    monkeypatch.setattr(_build, "on_cuda", lambda kernel, *t: True)
    monkeypatch.setattr(_build, "library", lambda: calls.append(1))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    pool = _rand(31, 2, 4, 8, 6).transpose(-1, -2)
    with pytest.raises(ValueError, match="not contiguous; the copy is made in place"):
        tk.paged_copy(pool, 1, 2)
    assert not calls and tk.launch_counts()["paged_copy"] == 0


def test_paged_copy_on_the_cpu_writes_through_a_view():
    base = _rand(32, 2, 4, 6, 8)
    pool = base.transpose(-1, -2)
    tk.paged_copy(pool, 1, 3)
    assert torch.equal(base[:, 3], base[:, 1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", ["view", "offset"])
@pytest.mark.parametrize("kernel", list(CASES))
def test_cuda_kernel_on_a_copy(cuda_card, kernel, form, dtype):
    """The kernel on a view (or an operand 4 bytes off a 16-byte address)
    gives its answer on the contiguous copy, bit for bit; the copies are
    counted apart from the launches."""
    call, make, aligned = CASES[kernel]
    args = [a.to(cuda_card) for a in make(dtype)]
    want = call(*args)
    moved = [_strided(a) if form == "view" else _offset(a) for a in args]
    assert all(m.data_ptr() % 16 == 4 for m in moved) or form == "view"
    copies = _build.operand_copies
    got = call(*moved)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    expect = len(moved) if form == "view" or aligned else 0
    assert _build.operand_copies == copies + expect
    counts = tk.launch_counts()
    assert counts[kernel] == 2 and sum(counts.values()) == 2


@pytest.mark.cuda
def test_cuda_paged_copy_refuses_a_view(cuda_card):
    pool = _rand(33, 2, 4, 8, 6).to(cuda_card).transpose(-1, -2)
    with pytest.raises(ValueError, match="made in place"):
        tk.paged_copy(pool, 1, 2)
    assert tk.launch_counts()["paged_copy"] == 0
