"""The Fisher-vector statistics wrapper's launch geometry and envelope
(keystone_tpu_torch/ops/fv_stats.py), on the CPU: the arithmetic that
decides how the CUDA kernel cuts a batch, which the card tests and
``chip_smoke.py`` then exercise."""

import pytest

from keystone_tpu_torch.ops import fv_stats as fs

VOC = (80, 73866, 256)  # d, descriptors of a 500x375 image, k


@pytest.mark.parametrize("cols", [1, fs.SPLIT_COLS - 1, fs.SPLIT_COLS, fs.SPLIT_COLS + 1, 73866])
def test_splits_do_not_depend_on_the_batch(cols):
    d, _, k = VOC
    geoms = [fs.launch_geometry(n, d, cols, k) for n in (1, 4, 16, 32, 384)]
    assert {g.splits for g in geoms} == {-(-cols // fs.SPLIT_COLS)}
    assert fs.SPLIT_COLS == fs.TILE * fs.TILES_PER_SPLIT


def test_one_voc_image_fills_most_of_an_h100():
    d, cols, k = VOC
    assert 0.9 * 132 <= fs.launch_geometry(1, d, cols, k).splits <= 132


def test_workspace_of_the_largest_voc_bucket():
    d, cols, k = VOC
    g = fs.launch_geometry(384, d, cols, k)
    per_image = g.splits * (k + 2 * d * k) * 4
    assert g.workspace_bytes == g.group * per_image <= 2.5e9
    assert 1 <= g.group < 384  # walked in groups, each the same size but the last
    small = fs.launch_geometry(4, d, cols, k)
    assert small.group == 4 and small.workspace_bytes == 4 * per_image


@pytest.mark.parametrize("d,k", [(80, 256), (64, 16), (24, 8), (16, 8), (3, 5)])
def test_envelope_takes_the_workload_widths(d, k):
    fs.check_envelope(d, k)


@pytest.mark.parametrize("d,k", [(8, 300), (81, 8), (0, 8), (8, 0)])
def test_envelope_rejects(d, k):
    with pytest.raises(ValueError, match="envelope"):
        fs.check_envelope(d, k)
