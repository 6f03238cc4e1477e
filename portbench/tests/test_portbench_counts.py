"""The frozen counts: the serving numbers the port's counts give, and the
arithmetic of the new ones."""

import pytest

from portbench import counts


def test_serving_counts_match_the_ports():
    assert counts.superpoint_dense(8, 512, 512)[0] / 1e9 == pytest.approx(355.69, abs=0.005)
    assert counts.pose_pipeline(8, 512, 512, 1000, 2000, 8)[0] / 1e9 == pytest.approx(
        632.28, abs=0.005)


def test_vgg_stages_are_the_encoder_convs():
    w = counts.vgg_stages(8, 512, 512)
    head = 0
    px = 8 * 64 * 64
    for k, cin, cout in ((3, 128, 256), (1, 256, 65), (3, 128, 256), (1, 256, 256)):
        head += 2 * k * k * cin * cout * px
    assert w.mm == counts.superpoint_dense(8, 512, 512)[0] - head
    assert w.elem == 0 and w.bytes > 8 * 512 * 512 * 4


def test_gats_blocks_scale_with_batch_and_blocks():
    one = counts.gats_blocks(1, 1000, 2000, 8, blocks=1)
    four = counts.gats_blocks(2, 1000, 2000, 8, blocks=4)
    wa = 2 * 2 * 256 * 256
    assert four.mm == pytest.approx(4 * (2 * (one.mm - wa) + wa))


def test_superglue_gnn_per_pair():
    w = counts.superglue_gnn(1, 4096, 4096)
    c, n = 256, 4096
    attention = (2 * 4 * n * c * c + 4 * n * n * c + 8 * n * c * c + 4 * n * c * c)
    enc = 2 * (3 * 32 + 32 * 64 + 64 * 128 + 128 * 256 + 256 * 256) * 2 * n
    assert w.mm == pytest.approx(9 * 4 * attention + enc + 4 * n * c * c + 2 * n * n * c)
    assert w.elem == 9 * 4 * 4 * n * n
    assert 0.8e12 < w.mm < 0.85e12


def test_sinkhorn_counts_three_ops_an_entry_a_half_step():
    w = counts.sinkhorn(7, 4096, 4096, 100)
    assert w.elem == 100 * 2 * 3 * 7 * 4097 * 4097
    assert w.mm == 0
    assert w.seconds() == pytest.approx(w.elem / counts.PEAK_FP32_FLOPS)


def test_bound_is_the_largest_of_three():
    assert counts.Work(989e12, 0, 0).seconds() == pytest.approx(1.0)
    assert counts.Work(0, 67e12, 0).seconds() == pytest.approx(1.0)
    assert counts.Work(1, 1, 3.35e12 * 2).seconds() == pytest.approx(2.0)
