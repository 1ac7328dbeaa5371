"""The fused DiceCE kernels (K8: forward sums and dlogits) against their
plain versions.

On the CPU: the launch path with a stand-in library (the slab count, the
label width and the launch counts handed over; a refused launch raises
without a count). On the card (``cuda`` marker, skipped elsewhere:
``python -m pytest --noconftest -m cuda tests/test_torch_dice_ce_cuda.py``):
batch 3 with a voxel count that is no multiple of the tile (so every batch
element but the first starts off a 16-byte boundary), batch 4 and 8 of
96^3 x 14 (the micro-step's and the step's logits), more than 16 classes,
labels outside [0, C), logits and labels that start off a 16-byte boundary,
int32 and int64 labels; class counts and reruns bit-equal.
"""

import pytest
import torch

from medicalsemseg_tpu_torch.ops import kernels
from medicalsemseg_tpu_torch.ops.kernels import dice_ce as k8


def _k8_launches():
    """K8's launches so far: (sums, dlogits)."""
    return (kernels.launches("K8", "forward"),
            kernels.launches("K8", "backward"))


class _FakeEntry:
    def __init__(self, err):
        self.err, self.calls = err, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.err


class _FakeLibrary:
    def __init__(self, err):
        self.medseg_dice_ce_sums = _FakeEntry(err)
        self.medseg_dice_ce_dlogits = _FakeEntry(err)

    def medseg_cuda_error_string(self, err):
        return b"launch refused"


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLibrary(0)
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(kernels, "stream_handle", lambda dev: None)
    monkeypatch.setattr(kernels, "resident_blocks", lambda dev: 528)
    return lib


@pytest.mark.parametrize("label_dtype", [torch.int32, torch.int64])
def test_launch_paths_hand_over_shapes_and_label_width(fake_lib, label_dtype):
    b, m, c = 3, 1000, 14
    logits = torch.zeros(b, m, c)
    labels = torch.zeros(b, m, dtype=label_dtype)
    before = _k8_launches()
    out = k8._launch_sums(logits, labels)
    assert out.shape == (b, 4, c)
    call = fake_lib.medseg_dice_ce_sums.calls[-1]
    assert call[4:9] == (b, m, c, 4, int(label_dtype == torch.int64))
    dl = k8._launch_dlogits(logits, labels, torch.zeros(b, c),
                            torch.zeros(b, c), torch.zeros(1))
    assert dl.shape == logits.shape
    call = fake_lib.medseg_dice_ce_dlogits.calls[-1]
    assert call[6:10] == (b, m, c, int(label_dtype == torch.int64))
    assert _k8_launches() == (before[0] + 1, before[1] + 1)


def test_slab_count_follows_the_card(fake_lib):
    """Four slabs an SM, shared among the batch elements, never more than
    the tiles of one element."""
    for b, m, want in ((4, 96 ** 3, 132), (8, 96 ** 3, 66), (3, 1000, 4),
                       (1, 256, 1)):
        logits = torch.empty(b, m, 1)
        k8._launch_sums(logits, torch.empty(b, m, dtype=torch.int32))
        assert fake_lib.medseg_dice_ce_sums.calls[-1][7] == want


def test_failed_launches_raise_and_count_nothing(fake_lib):
    fake_lib.medseg_dice_ce_sums.err = 1
    fake_lib.medseg_dice_ce_dlogits.err = 1
    logits, labels = torch.zeros(2, 10, 3), torch.zeros(2, 10,
                                                        dtype=torch.int64)
    before = _k8_launches()
    with pytest.raises(RuntimeError, match="launch refused"):
        k8._launch_sums(logits, labels)
    with pytest.raises(RuntimeError, match="launch refused"):
        k8._launch_dlogits(logits, labels, torch.zeros(2, 3),
                           torch.zeros(2, 3), torch.zeros(1))
    assert _k8_launches() == before


# ---- on the card

# sums: fp32 over up to 3.5e6 voxels in another order, the error's norm
# within 1e-4 of the reference's (chip_smoke.py SUM_NORM_TOL); dlogits:
# elementwise fp32 with another exp and order of the C-term sums, within
# 1e-5 of the norm (DLOGITS_NORM_TOL) and of max(1, the largest value)
SUM_NORM_TOL = 1e-4
DLOGITS_NORM_TOL = 1e-5


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(8)


def _unaligned(t):
    """A contiguous copy of t whose storage starts one element past a
    16-byte boundary."""
    flat = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    out = flat[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0
    return out


def _check_both(logits, labels, gen):
    b, m, c = logits.shape
    before = _k8_launches()
    got = k8.dice_ce_sums(logits, labels)
    torch.cuda.synchronize()
    want = k8.dice_ce_sums_plain(logits, labels)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert (got - want).norm() <= SUM_NORM_TOL * want.norm()
    assert torch.equal(got[:, 2], want[:, 2])                 # voxel counts
    assert torch.equal(got, k8.dice_ce_sums(logits, labels))  # bit-equal rerun
    ca = torch.randn(b, c, generator=gen, device="cuda")
    cp = torch.randn(b, c, generator=gen, device="cuda")
    ce = torch.rand(1, generator=gen, device="cuda")
    dl = k8.dice_ce_dlogits(logits, labels, ca, cp, ce)
    torch.cuda.synchronize()
    assert _k8_launches() == (before[0] + 2, before[1] + 1)
    ref = k8.dice_ce_dlogits_plain(logits, labels, ca, cp, ce)
    assert dl.shape == ref.shape and torch.isfinite(dl).all()
    assert (dl - ref).norm() <= DLOGITS_NORM_TOL * ref.norm()
    assert (dl - ref).abs().max() <= 1e-5 * max(1.0, float(ref.abs().max()))
    assert torch.equal(dl, k8.dice_ce_dlogits(logits, labels, ca, cp, ce))


@pytest.mark.cuda
@pytest.mark.parametrize("label_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("b,m,c", [
    (3, 100_003, 14),      # ragged M: elements 1, 2 start off 16 bytes
    (4, 96 ** 3, 14),      # the batch-4 micro-step
    (8, 96 ** 3, 14),      # a batch-8 step's logits
    (2, 5_001, 20),        # more than 16 classes
    (1, 70_001, 32),       # the widest the kernels take
    (5, 37, 3),            # less than a tile
])
def test_kernels_against_plain(gen, b, m, c, label_dtype):
    logits = torch.randn(b, m, c, generator=gen, device="cuda") * 2.0
    labels = torch.randint(0, c, (b, m), generator=gen,
                           device="cuda").to(label_dtype)
    _check_both(logits, labels, gen)


@pytest.mark.cuda
@pytest.mark.parametrize("label_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("b,m,c", [(3, 100_003, 14), (2, 4_099, 20)])
def test_labels_outside_the_classes(gen, b, m, c, label_dtype):
    """Labels -1 and C (and beyond): no one-hot row and no CE; p^2 left out
    for the negative ones only, as the JAX kernels do."""
    logits = torch.randn(b, m, c, generator=gen, device="cuda") * 2.0
    labels = torch.randint(-2, c + 2, (b, m), generator=gen,
                           device="cuda").to(label_dtype)
    assert (labels < 0).any() and (labels >= c).any()
    _check_both(logits, labels, gen)


@pytest.mark.cuda
@pytest.mark.parametrize("label_dtype", [torch.int32, torch.int64])
def test_tensors_off_a_16_byte_boundary(gen, label_dtype):
    """The bulk copies read the 16-byte aligned span around a tile; the
    stores start with scalars up to dlogits' first boundary."""
    b, m, c = 2, 3_001, 14
    logits = _unaligned(torch.randn(b, m, c, generator=gen, device="cuda"))
    labels = _unaligned(torch.randint(0, c, (b, m), generator=gen,
                                      device="cuda").to(label_dtype))
    _check_both(logits, labels, gen)
