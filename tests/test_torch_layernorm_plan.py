"""The host-side plan of the LayerNorm kernel (csrc/bwma_layernorm.cu): how
many 16-byte vectors of its row a lane holds, and which rows take the looped
path; and the source's rows per CTA.

The plan is Python so that it can be held here, without a card: every
launch it gives must be one the CUDA source instantiates and cover each row,
and the source's grid must fill the card at the BERT-base calls whatever
the block size.  The route
test drives the wrapper's CUDA branch against a stand-in library to pin what
reaches the entry point.
"""
import contextlib
import importlib
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build

ln = importlib.import_module("repro_torch.kernels.bwma_layernorm")

CU = Path(ln.__file__).with_name("csrc") / "bwma_layernorm.cu"
DTYPES = [torch.float32, torch.bfloat16]
ROWS = int(re.search(r"constexpr int kRows = (\d+);", CU.read_text()).group(1))  # per CTA


def _vec(dtype):
    return 16 // dtype.itemsize  # elements of one 16-byte vector


def test_plan_uses_only_what_the_cuda_source_instantiates():
    src = CU.read_text()
    nv = {int(n) for n in re.findall(r"bwma_layernorm_kernel<T, BN, (\d+)>", src)}
    assert nv == {0, *ln.VECTORS_PER_LANE}  # 0: the looped path
    assert re.search(rf"kMaxVectors = {ln.VECTORS_PER_LANE[-1]};", src)
    bns = {int(b) for b in re.findall(r"case (\d+): launch<T, \1>", src)}
    assert bns == set(_build.SUPPORTED_BLOCKS)
    assert ROWS == 4 and all(b % ROWS == 0 for b in bns)  # a CTA never straddles a block-row


# (batch, block): BERT-base, 512 rows of d_model 768 per sequence
BERT = [(batch, block) for batch in (4, 1) for block in _build.SUPPORTED_BLOCKS]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch,block", BERT)
def test_bert_base_fills_the_card_at_every_block(batch, block, dtype):
    rows, n = 512 * batch, -(-768 // block) * block
    per_lane, looped = ln.layernorm_plan(n, dtype)
    assert not looped and rows % ROWS == 0
    assert rows // ROWS >= 128  # at least 128 CTAs at batch 1, whatever the block
    assert per_lane == (8 if dtype == torch.float32 else 4)  # 6 or 3 vectors, rounded up


def test_bert_base_plan_is_pinned():
    """d_model 768: 8 fp32 or 4 bf16 vectors a lane, on the register path."""
    assert ln.layernorm_plan(768, torch.float32) == (8, False)
    assert ln.layernorm_plan(768, torch.bfloat16) == (4, False)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [8, 24, 72, 128, 256, 512, 768, 1024, 2048, 3072, 4096, 4104,
                               8192, 18432])
def test_looped_path_only_above_the_register_width(n, dtype):
    """A lane holds the power of two of vectors that covers the row, up to
    16; a row of more than 16 * 32 vectors (2048 fp32 or 4096 bf16
    columns) walks the looped path, as many vectors per pass as it needs."""
    per_lane, looped = ln.layernorm_plan(n, dtype)
    need = -(-n // (32 * _vec(dtype)))  # vectors per lane that cover the row
    width = 16 * 32 * _vec(dtype)
    assert looped == (n > width)
    if looped:
        assert per_lane == need > 16
    else:
        assert per_lane in ln.VECTORS_PER_LANE and need <= per_lane < 2 * max(need, 1)
        assert 32 * per_lane * _vec(dtype) >= n


class _FakeLib:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def fake_card(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(_build, "on_cuda", lambda kernel, *t: True)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    ln.bwma_layernorm.launches = 0
    yield lib
    ln.bwma_layernorm.launches = 0


@pytest.mark.parametrize("lead,gm,gn,block,dtype,strides", [
    # strides of x along the two launch-grid lead dims, in slots; 0 where
    # the dim is absent or of size 1
    ((4,), 32, 48, 16, torch.float32, (0, 1)),    # BERT-base block 16, batch 4
    ((), 4, 6, 128, torch.bfloat16, (0, 0)),      # BERT-base block 128, one sequence
    ((2, 3), 2, 40, 128, torch.float32, (3, 1)),  # 5120 columns: the looped path
    ((3, 1), 2, 5, 8, torch.bfloat16, (1, 0)),
] + [((4,), 1, -(-768 // block), block, dtype, (0, 1))  # d_model 768 at every block
     for block in _build.SUPPORTED_BLOCKS for dtype in DTYPES])
def test_route_passes_the_plan_and_the_lead_strides(fake_card, lead, gm, gn, block, dtype,
                                                    strides):
    x = torch.zeros(*lead, gm, gn, block, block, dtype=dtype)
    g = torch.zeros(gn, block)
    n = gn * block - 3
    ln.bwma_layernorm(x, g, g, n)
    (name, args), = fake_card.calls
    slots = x.numel() // (gm * gn * block * block)
    per_lane, looped = ln.layernorm_plan(gn * block, dtype)
    assert name == "bwma_layernorm" and args[7] * args[8] == slots
    slot = gm * gn * block * block  # one slot's elements
    assert args[9:11] == tuple(s * slot for s in strides)
    assert args[11:17] == (gm, gn, block, block, n, pytest.approx(1e-5))
    assert args[17] == (0 if looped else per_lane)
    assert looped == (gn * block == 5120)
    assert ln.bwma_layernorm.launches == 1

